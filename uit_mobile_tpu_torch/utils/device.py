"""Device resolution shared by the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """-> torch.device, refusing a CUDA device when there is no GPU.

    Entry points default to ``"cuda"``; only a caller that asks for
    ``"cpu"`` runs on the CPU. TF32 is switched off for matmuls and
    convolutions: the parity budgets of the port assume full float32."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA GPU is available; "
            f"pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}; expected cuda or cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


_CONSTANTS: dict = {}


def device_constant(key, dtype, device, make) -> torch.Tensor:
    """``make()`` (an array) as a ``dtype`` tensor on ``device``, moved once
    per (key, dtype, device): a forward or a step on the card then copies
    nothing from the host (a CUDA graph could not). ``key`` names the
    constant and must be hashable. Under a trace (``torch.export``) the
    tensor is the trace's and never cached."""
    full = (key, dtype, torch.device(device))
    t = _CONSTANTS.get(full)
    if t is None:
        t = torch.as_tensor(make(), dtype=dtype, device=device)
        if not torch.compiler.is_compiling():
            _CONSTANTS[full] = t
    return t
