"""Best-available eval forward dispatch, counterpart of
``uit_mobile_tpu/ops/pipeline.py``.

``make_forward_fn`` is the one place that encodes the layout/precision
policy: where the kernel is available (the model lives on a CUDA device),
the fused mel kernel feeds the UiT encoder in the transposed 'tfb' layout
with init_bn folded into the patch embed; elsewhere the rfft reference
frontend feeds the canonical 'bft' path.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import uit
from ..models.uit import UITConfig
from ..utils.device import resolve_device
from .mel import make_frontend_fn


def make_forward_fn(cfg: UITConfig, model, use_kernel: Optional[bool] = None,
                    precision: str = "exact", top_db_mode: Optional[str] = None,
                    btf: Optional[bool] = None):
    """Eval forward fn(wav) -> probs on the model's device.

    use_kernel: None = the fused kernel whenever the model is on CUDA.
    With use_kernel=True on a CPU model the kernel's plain version runs.
    precision: 'exact' (parity grade) or 'fast' (3-pass bf16 DFT; serving).
    top_db_mode: override the frontend's dB-clamp reference ('per_sample'
    for serving isolation); None keeps the config's mode.
    btf: None = the 'tfb' layout whenever the kernel runs; False pins the
    plain 'bft' chain (the A/B escape hatch). The model config's mel_layout
    is always pinned to the frontend's actual layout.
    ``wav`` is a (B, T) float32 or int16 tensor or array."""
    if isinstance(model, (list, tuple)):
        raise NotImplementedError("ensembles in make_forward_fn are not yet ported")
    if not isinstance(cfg, UITConfig):
        raise NotImplementedError(f"config type {type(cfg).__name__} is not yet ported")
    device = resolve_device(next(model.parameters()).device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    layout = "tfb" if use_kernel and btf is not False else "bft"
    fe_cfg = cfg.frontend
    if top_db_mode is not None:
        fe_cfg = dataclasses.replace(fe_cfg, top_db_mode=top_db_mode)
    run_cfg = dataclasses.replace(cfg, mel_layout=layout, frontend=fe_cfg)
    frontend = make_frontend_fn(fe_cfg, use_kernel=use_kernel, precision=precision,
                                layout=layout)

    @torch.inference_mode()
    def fn(wav):
        wav = torch.as_tensor(wav).to(device)
        return uit.forward(run_cfg, model, wav, frontend_fn=frontend)

    return fn


def make_scanned_forward(fwd_fn):
    """(K, B, T) wav block -> (K, B, C) probs, the K batches run one after
    another through ``fwd_fn``."""

    def scanned(wav_block):
        return torch.stack([fwd_fn(wav_block[k]) for k in range(len(wav_block))])

    return scanned
