"""FLOP accounting + MFU (model FLOPs utilization), counterpart of
``uit_mobile_tpu/utils/flops.py``.

Two FLOP sources, cross-checked in tests/test_torch_flops.py:

- ``counted_flops(fn, *args)``: PyTorch's own count of the matmuls and
  convolutions one call runs (``torch.utils.flop_counter.FlopCounterMode``).
  The fused mel kernel is the operator ``log_mel_rows``, whose registered
  formula counts its plain version's DFT and filterbank products on either
  device.
- ``uit_forward_flops(cfg, n_samples)``: the analytic hand model for the
  UiT families (DFT-as-matmul + filterbank + patch embed + encoder + head),
  term by term. For uit_xs on a 1 s clip this is ~128 MFLOP: DFT 53 + fb
  6.6 + embed 1.6 + encoder 67 + head 0.1.

Peaks: dense rates from NVIDIA's data sheet of the card the name names. An
unknown card returns None, and MFU is omitted rather than guessed.
"""

from __future__ import annotations

from typing import Optional

import torch

# card name prefix (torch.cuda.get_device_name) -> dense bf16 tensor-core
# peak FLOP/s. NVIDIA H100 Tensor Core GPU data sheet: "H100 SXM" column
# 989 TFLOPS bf16 (the 1,979 of the sheet is with sparsity), "H100 PCIe"
# column 756 TFLOPS. Matching runs in order, so the PCIe name comes first.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 PCIe": 756e12,
    "NVIDIA H100": 989e12,  # the SXM part ("NVIDIA H100 80GB HBM3")
}

# card name prefix -> device-memory bandwidth (bytes/s), same data sheet:
# H100 SXM 3.35 TB/s (HBM3), H100 PCIe 2.0 TB/s (HBM2e).
HBM_BANDWIDTH = {
    "NVIDIA H100 PCIe": 2.0e12,
    "NVIDIA H100": 3.35e12,
}


def _device_lookup(table: dict, device=None) -> Optional[float]:
    """``device``: a card's name, a CUDA device, or None (the current card;
    None without one)."""
    if device is None or not isinstance(device, str):
        if not torch.cuda.is_available():
            return None
        device = torch.cuda.get_device_name(device)
    for name, val in table.items():
        if device.startswith(name):
            return val
    return None


def device_peak_flops(device=None) -> Optional[float]:
    """Dense bf16 peak of a card (None if its name is not in the table)."""
    return _device_lookup(PEAK_BF16_FLOPS, device)


def device_hbm_bandwidth(device=None) -> Optional[float]:
    """Device-memory bandwidth (bytes/s) of a card (None if unknown)."""
    return _device_lookup(HBM_BANDWIDTH, device)


def counted_flops(fn, *args, **kwargs) -> float:
    """FLOPs of one call ``fn(*args, **kwargs)`` as FlopCounterMode counts
    them (matmuls, convolutions, attention products); the mel operator
    counts its plain version's products (``ops/mel.py``), on either device."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# ------------------------------------------------------- analytic hand model

def frontend_flops(fe_cfg, n_samples: int) -> float:
    """Fused mel frontend, logical float32 count: packed-DFT matmul + power +
    filterbank matmul."""
    n_frames = fe_cfg.num_frames(n_samples)
    lanes = fe_cfg.n_fft  # packed [cos|sin] fills exactly n_fft lanes
    dft = 2.0 * n_frames * fe_cfg.n_fft * lanes
    power = float(n_frames * lanes)
    fb = 2.0 * n_frames * lanes * fe_cfg.n_mels
    return dft + power + fb


def uit_encoder_flops(cfg, n_tokens: Optional[int] = None) -> float:
    """Transformer encoder, per window: qkv/attention/proj/MLP matmuls
    (LN and elementwise omitted, under 1 % at these shapes)."""
    D = cfg.embed_dim
    N = n_tokens if n_tokens is not None else (
        cfg.grid_size[0] * cfg.grid_size[1] + (1 if cfg.pooling == "token" else 0)
    )
    inner = cfg.inner_dim
    hd = inner // cfg.num_heads
    hidden = int(D * cfg.mlp_ratio)
    per_block = (
        2.0 * N * D * 3 * inner          # qkv
        + 2.0 * cfg.num_heads * N * N * hd * 2  # QK^T and AV
        + 2.0 * N * inner * D            # proj
        + 2.0 * N * D * hidden * 2       # MLP fc1 + fc2
    )
    return cfg.depth * per_block


def uit_forward_flops(cfg, n_samples: int) -> float:
    """Full eval forward for one clip of ``n_samples`` (the hand model)."""
    fe = frontend_flops(cfg.frontend, n_samples)
    n_frames = cfg.frontend.num_frames(n_samples)
    n_windows = max(1, -(-n_frames // cfg.target_length))
    ps = cfg.patch_size
    fg, tg = cfg.grid_size
    embed = 2.0 * fg * tg * (ps * ps) * cfg.embed_dim
    head = 2.0 * cfg.embed_dim * cfg.outputdim
    return fe + n_windows * (embed + uit_encoder_flops(cfg) + head)


def train_step_flops(forward_flops: float) -> float:
    """Standard fwd+bwd matmul accounting: backward costs 2x forward."""
    return 3.0 * forward_flops


def mfu(flops_per_second: float, device=None) -> Optional[float]:
    peak = device_peak_flops(device)
    if peak is None:
        return None
    return flops_per_second / peak


def hbm_util(bytes_per_second: float, device=None) -> Optional[float]:
    """Achieved device-memory traffic / data-sheet bandwidth (None if the
    card is unknown); the bytes-side twin of :func:`mfu`."""
    bw = device_hbm_bandwidth(device)
    if bw is None:
        return None
    return bytes_per_second / bw


# ------------------------------------------- analytic per-stage byte model

def uit_serve_stage_bytes(cfg, batch: int, n_samples: int,
                          dtype: str = "int16") -> dict:
    """Hand model of device-memory bytes per serving batch, stage by stage,
    for the serving 'tfb' path (``ops.pipeline.make_forward_fn``). Each stage
    counts its reads + writes once; reuse inside a kernel is not charged.
    The stages are the JAX package's, term by term, so the two models stay
    comparable; on the card the mel kernel reads frames straight from the
    padded wave, so its first two stages are an upper bound there.

    Returns ``{stage: bytes, ..., 'total': bytes}``.
    """
    fe = cfg.frontend
    wav_b = 2 if dtype == "int16" else 4
    P = fe.num_frames(n_samples)  # 101 frames for a 1 s clip
    Tp = n_samples + fe.n_fft  # reflect pad n_fft//2 each side
    F = fe.n_mels
    D = cfg.embed_dim
    fg, tg = cfg.grid_size
    N = fg * tg + (1 if cfg.pooling == "token" else 0)
    inner = cfg.inner_dim
    hidden = int(D * cfg.mlp_ratio)

    stages = {
        # (B, T) wav -> padded transposed (Tp, B): read + write
        "wav_transpose_pad": batch * (n_samples + Tp) * wav_b,
        # hop-strided framing: read padded wav, write (P*n_fft, B) frames
        "framing_gather": batch * (Tp + P * fe.n_fft) * wav_b,
        # fused mel kernel: read frames, write (P, F, B) f32 dB mel
        "mel_kernel": batch * (P * fe.n_fft * wav_b + P * F * 4),
        # top_db clamp: read mel, write clamped mel
        "top_db": batch * 2 * P * F * 4,
        # BN-folded patch embed: read mel once, write (B, N, D) tokens
        "patch_embed": batch * (P * F * 4 + N * D * 4),
        # encoder: per block residual reads/writes, qkv out + attention
        # out, proj out, MLP hidden write + read; weights once a batch
        "encoder_activations": batch * cfg.depth * (
            4 * N * D * 4
            + 3 * N * inner * 4
            + N * D * 4
            + 2 * N * hidden * 4
        ),
        "weights_stream": (
            cfg.depth * (D * 3 * inner + inner * D + 2 * D * hidden) + D * cfg.outputdim
        ) * 4,
        # head: read pooled (B, D), write (B, outputdim) probs
        "head": batch * (D + cfg.outputdim) * 4,
    }
    stages["total"] = sum(stages.values())
    return stages
