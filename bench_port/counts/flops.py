"""The logical work of the benchmark's cells, from shapes alone: the same
whatever implements it (a kernel's passes, padding and operand copies are
not counted).

- The mel: the DFT as one real matmul of each frame against the packed
  [cos | sin] basis (``n_fft`` columns: the sine of bins 0 and n_fft/2 is
  zero), the power, and the filterbank over the ``n_fft // 2 + 1`` bins;
  bytes: the wave read once, the mel written once (float32).
- The encoder: patch embed, qkv, attention products, projection, MLP (or
  the routed experts: ``top_k`` expert MLPs a token, not the capacity's
  padding, plus the router), the head; norms and elementwise work left out.
- A train step: the forward, plus twice the forward of everything that
  takes a gradient (the mel does not).

Peaks of one NVIDIA H100 SXM (the data sheet, dense): 989 TFLOP/s bf16,
the one peak every utilization here is held against, and 3.35 TB/s HBM3.
"""

from __future__ import annotations

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def frames(fe: dict, n_samples: int) -> int:
    return 1 + n_samples // fe["hop_length"]


def mel_flops(fe: dict, n_samples: int) -> float:
    n, nfft = frames(fe, n_samples), fe["n_fft"]
    n_freqs = nfft // 2 + 1
    return 2.0 * n * nfft * nfft + n * nfft + 2.0 * n * n_freqs * fe["n_mels"]


def mel_bytes(fe: dict, n_samples: int, wav_bytes: int = 2) -> float:
    return n_samples * wav_bytes + frames(fe, n_samples) * fe["n_mels"] * 4.0


def mel_bound_s(fe: dict, rows: int, n_samples: int, wav_bytes: int = 2) -> float:
    """The least time of one launch over ``rows`` clips: the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return max(rows * mel_flops(fe, n_samples) / PEAK_FLOPS,
               rows * mel_bytes(fe, n_samples, wav_bytes) / PEAK_BYTES)


def encoder_flops(cfg: dict, n_tokens: int) -> float:
    """One window of ``n_tokens`` patch tokens through the blocks."""
    D, depth = cfg["embed_dim"], cfg["depth"]
    inner = D // 4 if cfg["attention"] == "BNeckAttention" else D
    hidden = int(D * cfg["mlp_ratio"])
    N = n_tokens
    attn = 2.0 * N * D * 3 * inner + 2.0 * 2 * N * N * inner + 2.0 * N * inner * D
    moe = cfg.get("moe")
    if moe is None:
        mlp = 2.0 * N * D * hidden * 2
    else:
        mlp = moe["top_k"] * 2.0 * N * D * hidden * 2 + 2.0 * N * D * moe["n_experts"]
    return depth * (attn + mlp)


def window_flops(cfg: dict, n_frames: int) -> float:
    """Patch embed, blocks and head of one window of ``n_frames`` frames."""
    ps, D = cfg["patch_size"], cfg["embed_dim"]
    n_tokens = (cfg["n_mels"] // ps) * (n_frames // ps)
    return (2.0 * n_tokens * ps * ps * D + encoder_flops(cfg, n_tokens)
            + 2.0 * D * cfg["outputdim"])


def forward_flops(cfg: dict, n_samples: int) -> float:
    """One clip of ``n_samples`` samples: its mel, and its windows of
    ``target_length`` frames (a clip at most that long is one window of
    its own frames)."""
    fe = cfg["frontend"]
    n, L = frames(fe, n_samples), cfg["target_length"]
    windows = [n] if n <= L else [L] * (-(-n // L))
    return mel_flops(fe, n_samples) + sum(window_flops(cfg, w) for w in windows)


def train_step_flops(cfg: dict, batch: int, n_samples: int) -> float:
    """One step over ``batch`` single-window clips."""
    mel = batch * mel_flops(cfg["frontend"], n_samples)
    model = batch * (forward_flops(cfg, n_samples) - mel_flops(cfg["frontend"], n_samples))
    return mel + 3.0 * model
