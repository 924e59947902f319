"""Fused log-mel frontend: the CUDA kernel's wrapper and its plain versions.

Counterpart of ``uit_mobile_tpu/ops/pallas_mel.py``. One CUDA kernel
(``csrc/mel.cu``) replaces its four Pallas kernels:

=============  ===========================================  ==================
variant        Pallas kernel replaced                       output
=============  ===========================================  ==================
``row_exact``  ``_mel_kernel`` (pallas_mel.py:101)          (B, n_frames, 64)
``row_fast``   ``_mel_kernel_fast`` (pallas_mel.py:142)     (B, n_frames, 64)
``tfb_exact``  ``_mel_kernel_t`` (pallas_mel.py:180)        (n_frames, 64, B)
``tfb_fast``   ``_mel_kernel_fast_t`` (pallas_mel.py:192)   (n_frames, 64, B)
=============  ===========================================  ==================

The wrapper reflect-pads the wave (a torch op) and hands the padded
(B, T + n_fft) wave to the kernel, which reads hop-strided frames from it
directly. Both precisions run the filterbank product as a 3-pass bf16
hi/lo split; the DFT runs as 6 bf16 passes of a hi/mid/lo split
(``exact``, FP32-grade, what the Pallas kernel's Precision.HIGHEST runs on
the TPU) or 3 of a hi/lo split (``fast``). The kernel reads copies of G and
the filterbank pre-packed in the order its wgmma reads them (``_matrices``
builds them once, with ``pack_operands``). The launch is the operator
``torch.ops.uit_mobile_tpu_torch.log_mel_rows`` (``log_mel_rows``), so that
an exported program (``ckpt/artifact.py``) can call it: a tensor on the CPU
takes its CPU implementation, the plain PyTorch version of the same
computation; a CUDA tensor launches the kernel or raises. The top_db clamp
stays outside the kernel: it needs a max over frames (per sample) or over
the batch (``top_db_mode='torch'``).
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from ..frontend.mel import (FrontendConfig, log_mel_spectrogram, mel_filterbank,
                            padded_window, reflect_pad)
from ..parallel.rows import global_max

# Batch floor of the transposed ('tfb') kernel, as in the JAX package:
# below it a 'tfb' request takes the row kernel and transposes its output.
TFB_MIN_BATCH = 128
# the kernel is compiled for these sizes (csrc/mel.cu N_FFT, LANES, N_MELS)
KERNEL_N_FFT = 512
KERNEL_N_MELS = 64
# kernel tiles (csrc/mel.cu HALF, Ring<PASSES>::BK): DFT columns per
# accumulator pass, and K depth per ring stage for each precision
KERNEL_HALF = 256
KERNEL_BK = {"fast": 32, "exact": 16}
# The kernel is held to its plain version within TOL_DB plus
# TOL_ROUNDINGS[precision] float32 roundings of each DFT sum (tolerance_db):
# 2-3x the largest kernel-vs-float64 plus plain-vs-float64 readings on the
# H100 (PERF.md; fast 1.36 + 1.05, exact 0.53 + 1.25).
TOL_DB = 1e-3
TOL_ROUNDINGS = {"fast": 8, "exact": 4}

# Launch counters, one per kernel variant: each is incremented exactly where
# the wrapper launches that variant on the card (under a lock: the replicas
# of an in-process mesh launch from their own threads).
launches = {"row_exact": 0, "row_fast": 0, "tfb_exact": 0, "tfb_fast": 0}
_launches_lock = threading.Lock()

_DB = 10.0 / math.log(10.0)
_AMIN = 1e-10


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@functools.lru_cache(maxsize=4)
def _dft_matrices(n_fft: int, win_length: int, n_freqs: int):
    """Window-folded packed DFT matrix + matching mel-filterbank row map.

    One product gives all real/imaginary DFT components packed into
    ``lanes`` columns: the sin columns of k=0 and k=n_fft/2 are zero, so
    cos(n_freqs) + sin(n_freqs-2) columns fill exactly n_fft lanes. Squaring
    and multiplying by a filterbank whose rows repeat each bin's mel weights
    at the matching columns gives mel power = fb @ (Re^2 + Im^2).

    Returns (G (n_fft, lanes) float32, col_bin (lanes,) column -> freq bin).
    """
    w = padded_window(win_length, n_fft, dtype=np.float64)
    n = np.arange(n_fft, dtype=np.float64)[:, None]
    k = np.arange(n_freqs, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    cos_part = (w[:, None] * np.cos(ang))
    sin_part = (w[:, None] * np.sin(ang))[:, 1:n_freqs - 1]  # drop k=0, k=N/2
    lanes = _round_up(n_freqs + (n_freqs - 2), 128)
    G = np.zeros((n_fft, lanes), dtype=np.float32)
    G[:, :n_freqs] = cos_part.astype(np.float32)
    G[:, n_freqs: 2 * n_freqs - 2] = sin_part.astype(np.float32)
    col_bin = np.full((lanes,), -1, dtype=np.int64)
    col_bin[:n_freqs] = np.arange(n_freqs)
    col_bin[n_freqs: 2 * n_freqs - 2] = np.arange(1, n_freqs - 1)
    return G, col_bin


def _fb_rows(config: FrontendConfig, col_bin: np.ndarray) -> np.ndarray:
    """(lanes, n_mels) filterbank with each bin's row at its packed columns."""
    fb = np.zeros((col_bin.shape[0], config.n_mels), dtype=np.float32)
    valid = col_bin >= 0
    fb[valid] = mel_filterbank(config)[col_bin[valid]]
    return fb


def _bf16_split(M: torch.Tensor):
    """hi/lo bf16 decomposition of a float32 tensor for 3-pass split products."""
    hi = M.to(torch.bfloat16)
    lo = (M - hi.float()).to(torch.bfloat16)
    return hi, lo


def _bf16_split3(M: torch.Tensor):
    """hi/mid/lo bf16 decomposition of a float32 tensor for the exact DFT's
    6-pass products: each piece the bf16 rounding of what the earlier ones
    leave (the float32 subtractions are exact). A PCM value (<= 16
    significant bits) gives lo = 0."""
    hi = M.to(torch.bfloat16)
    rest = M - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


_MATRICES: dict = {}


def _matrices(config: FrontendConfig, pcm16: bool, precision: str, device):
    """The kernel's constant operands on ``device`` (``_build_matrices``),
    built once per key. Under a trace (``torch.export``) the tensors are
    the trace's and never cached: a caller that exports builds them first,
    so that the program holds them as constants (ckpt/artifact.py)."""
    key = (config, pcm16, precision, torch.device(device))
    mats = _MATRICES.get(key)
    if mats is None:
        mats = _build_matrices(*key)
        if not torch.compiler.is_compiling():
            _MATRICES[key] = mats
    return mats


def _build_matrices(config: FrontendConfig, pcm16: bool, precision: str,
                    device: torch.device):
    """Host prep of the kernel's constant operands, on ``device``:
    exact -> (G float32, None, fb_hi, fb_lo, gpack, fbpack); fast -> (G_hi,
    G_lo, fb_hi, fb_lo, gpack, fbpack), the pieces bf16. gpack and fbpack
    hold G's bf16 pieces (exact: hi/mid/lo; fast: hi/lo) and the filterbank's
    hi/lo packed as the kernel reads them (``pack_operands``). int16 input
    folds the 1/32768 PCM scale into G (exact: a power-of-two exponent
    shift)."""
    G, col_bin = _dft_matrices(config.n_fft, config.win_length, config.n_freqs)
    scale = np.float32(1.0 / 32768.0) if pcm16 else np.float32(1.0)
    G = torch.from_numpy(G * scale).to(device)
    fb = _bf16_split(torch.from_numpy(_fb_rows(config, col_bin)).to(device))
    if precision == "exact":
        return (G, None, *fb) + pack_operands(_bf16_split3(G), fb, KERNEL_BK["exact"])
    g = _bf16_split(G)
    return (*g, *fb) + pack_operands(g, fb, KERNEL_BK["fast"])


def _core_matrix_tiles(m: torch.Tensor, tile_rows: int, tile_k: int) -> torch.Tensor:
    """(R, K) matrix, K contiguous -> (n_tiles, tile_rows * tile_k): its
    (tile_rows, tile_k) tiles in row-tile-major order, each laid out as
    wgmma's K-major operand without swizzle: 8-row x 8-K core matrices of
    128 contiguous bytes, ordered (k // 8, r // 8, r % 8, k % 8)."""
    R, K = m.shape
    t = m.reshape(R // tile_rows, tile_rows // 8, 8, K // tile_k, tile_k // 8, 8)
    return t.permute(0, 3, 4, 1, 2, 5).reshape(-1, tile_rows * tile_k)


def pack_operands(g_pieces, fb_pieces, bk: int):
    """The kernel's constant operands in the order it copies them: gpack
    holds, for each step t = half * (512 // bk) + kstep, the G^T tile of 256
    columns x bk K of each piece in turn ([hi | lo] fast, [hi | mid | lo]
    exact); fbpack holds, per half, the filterbank^T tile of 64 mels x 256
    columns as [hi | lo]. Flat bf16, on their device."""
    def pack(pieces, tile_rows, tile_k):
        tiles = [_core_matrix_tiles(m.t(), tile_rows, tile_k) for m in pieces]
        return torch.stack(tiles, 1).reshape(-1).contiguous()

    return (pack(g_pieces, KERNEL_HALF, bk),
            pack(fb_pieces, KERNEL_N_MELS, KERNEL_HALF))


def _tri_dot(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> torch.Tensor:
    """3-pass bf16 split product hi*hi + hi*lo + lo*hi, each bf16 product
    exact in float32 and accumulated in float32."""
    a_hi, a_lo = _bf16_split(a)
    a_hi, a_lo, b_hi, b_lo = a_hi.float(), a_lo.float(), b_hi.float(), b_lo.float()
    return a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi


def plain_log_mel_rows(wavp: torch.Tensor, mats, precision: str, hop: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: reflect-padded (B, Tp) wave ->
    (B, n_frames, n_mels) log-mel dB (no top_db clamp)."""
    frames = wavp.unfold(-1, KERNEL_N_FFT, hop).float()  # int16 -> float is exact
    g_a, g_b, fb_hi, fb_lo = mats[:4]
    g = frames @ g_a if precision == "exact" else _tri_dot(frames, g_a, g_b)
    mel = _tri_dot(g * g, fb_hi, fb_lo)
    return _DB * torch.log(torch.clamp(mel, min=_AMIN))


def dft_rounding_db(wavp: torch.Tensor, mats, hop: int, roundings: float) -> torch.Tensor:
    """(B, n_frames, n_mels): how far the log-mel moves, in dB, when every
    DFT value g_c moves by ``roundings`` float32 roundings of
    S_c = sum_n |F_n G_nc| on the side that raises mel power; G and the
    filterbank as ``mats`` of either precision carry them.

    Two float32 evaluations of the DFT differ on that scale, not on the
    scale of g_c: where g_c cancels (frame 0 of a reflect-padded clip has no
    sine part, and mel 0 is DFT bin 1 alone) it is a large share of g_c."""
    frames = wavp.unfold(-1, KERNEL_N_FFT, hop).float()
    G = mats[0].float() + (0.0 if mats[1] is None else mats[1].float())
    fb = mats[2].float() + mats[3].float()
    g = frames @ G
    d = roundings * 2.0 ** -24 * (frames.abs() @ G.abs())
    mel = torch.clamp((g * g) @ fb, min=_AMIN)
    return _DB * torch.log1p(((2 * g.abs() + d) * d) @ fb / mel)


def tolerance_db(wavp: torch.Tensor, mats, hop: int, precision: str) -> torch.Tensor:
    """(B, n_frames, n_mels) bound for |kernel - plain_log_mel_rows| in dB:
    TOL_DB plus TOL_ROUNDINGS[precision] roundings of each DFT sum."""
    return TOL_DB + dft_rounding_db(wavp, mats, hop, TOL_ROUNDINGS[precision])


def log_mel_rows_float64(wavp: torch.Tensor, mats, hop: int, precision: str) -> torch.Tensor:
    """The DFT (exact: frames @ G; fast: the 3-pass products of the same
    bf16 operands) and the 3-pass filterbank product summed in float64,
    power squared in float32 as the kernel does: the value every float32
    summation order of that precision approximates."""
    frames = wavp.unfold(-1, KERNEL_N_FFT, hop).float()
    if precision == "exact":
        g = frames.double() @ mats[0].double()
    else:
        f_hi, f_lo = (m.double() for m in _bf16_split(frames))
        g_hi, g_lo = (m.double() for m in mats[:2])
        g = f_hi @ g_hi + f_hi @ g_lo + f_lo @ g_hi
    g = g.float()
    fb_hi, fb_lo = (m.double() for m in mats[2:4])
    p_hi, p_lo = (m.double() for m in _bf16_split(g * g))
    mel = p_hi @ fb_hi + p_hi @ fb_lo + p_lo @ fb_hi
    return _DB * torch.log(torch.clamp(mel, min=_AMIN))


_C_SIGNATURE = ([ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3
                + [ctypes.c_int] * 4 + [ctypes.c_void_p])


@functools.lru_cache(maxsize=1)
def _kernel_fn():
    from .build import load_library

    fn = load_library("mel").uit_log_mel
    fn.argtypes = _C_SIGNATURE
    fn.restype = ctypes.c_int
    return fn


def cuda_log_mel_rows(wavp: torch.Tensor, mats, precision: str, hop: int,
                      transposed: bool) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream: reflect-padded (B, Tp)
    wave -> (B, n_frames, 64), or (n_frames, 64, B) when ``transposed``."""
    if wavp.device.type != "cuda":
        raise ValueError(f"the CUDA mel kernel needs a CUDA tensor, got {wavp.device}")
    if wavp.dtype not in (torch.float32, torch.int16) or wavp.dim() != 2:
        raise ValueError(f"wave must be (B, T) float32 or int16, got "
                         f"{tuple(wavp.shape)} {wavp.dtype}")
    if not wavp.is_contiguous():
        raise ValueError("wave must be contiguous")
    if precision not in KERNEL_BK:
        raise ValueError(f"unknown precision {precision!r}; expected 'exact' or 'fast'")
    fast = precision == "fast"
    # G's bf16 pieces (fast 2, exact 3) and the filterbank's hi/lo, packed
    sizes = ((2 if fast else 3) * KERNEL_N_FFT * KERNEL_N_FFT, 2 * KERNEL_N_FFT * KERNEL_N_MELS)
    packed = mats[4:]
    if len(packed) != 2:
        raise ValueError(f"kernel operands for precision {precision!r} carry no packed copies")
    for m, size in zip(packed, sizes):
        if (m.device != wavp.device or m.dtype != torch.bfloat16 or m.dim() != 1
                or m.numel() != size or not m.is_contiguous()):
            raise ValueError(f"packed kernel operand {tuple(m.shape)} {m.dtype} on {m.device} "
                             f"does not match ({size},) bfloat16 on {wavp.device}")
    B, Tp = wavp.shape
    n_frames = (Tp - KERNEL_N_FFT) // hop + 1
    if n_frames < 1 or B < 1:
        raise ValueError(f"no frames in a ({B}, {Tp}) padded wave")
    if B * n_frames >= 2 ** 31:
        raise ValueError(f"batch too large for the kernel: {B} x {n_frames} frames")
    shape = (n_frames, KERNEL_N_MELS, B) if transposed else (B, n_frames, KERNEL_N_MELS)
    out = torch.empty(shape, dtype=torch.float32, device=wavp.device)
    g, fb = packed
    with torch.cuda.device(wavp.device):
        stream = torch.cuda.current_stream(wavp.device).cuda_stream
        rc = _kernel_fn()(wavp.data_ptr(), int(wavp.dtype == torch.int16),
                          int(fast), int(transposed), g.data_ptr(), fb.data_ptr(),
                          out.data_ptr(), B, Tp, n_frames, hop, stream)
    if rc != 0:
        raise RuntimeError(f"uit_log_mel kernel launch failed with CUDA error {rc}")
    with _launches_lock:
        launches[f"{'tfb' if transposed else 'row'}_{precision}"] += 1
    return out


@torch.library.custom_op("uit_mobile_tpu_torch::log_mel_rows", mutates_args=(),
                         device_types="cpu")
def log_mel_rows(wavp: torch.Tensor, g_a: torch.Tensor, g_b: Optional[torch.Tensor],
                 fb_hi: torch.Tensor, fb_lo: torch.Tensor, gpack: torch.Tensor,
                 fbpack: torch.Tensor, precision: str, hop: int,
                 transposed: bool) -> torch.Tensor:
    """The mel kernel as an operator that ``torch.export`` can carry:
    reflect-padded (B, Tp) wave and ``_matrices``' six operands ->
    (B, n_frames, 64), or (n_frames, 64, B) when ``transposed``. On CUDA
    tensors it launches the kernel (``cuda_log_mel_rows``, which counts
    the launch); this CPU implementation is the plain version."""
    mel = plain_log_mel_rows(wavp, (g_a, g_b, fb_hi, fb_lo), precision, hop)
    return mel.permute(1, 2, 0).contiguous() if transposed else mel


@log_mel_rows.register_kernel("cuda")
def _log_mel_rows_cuda(wavp, g_a, g_b, fb_hi, fb_lo, gpack, fbpack, precision, hop,
                       transposed):
    return cuda_log_mel_rows(wavp, (g_a, g_b, fb_hi, fb_lo, gpack, fbpack), precision, hop,
                             transposed)


@register_flop_formula(torch.ops.uit_mobile_tpu_torch.log_mel_rows)
def _log_mel_rows_flops(wavp, g_a, g_b, fb_hi, fb_lo, gpack, fbpack, precision, hop,
                        transposed, out_shape=None, **kwargs) -> int:
    """FLOPs of the plain version's products, as FlopCounterMode counted them
    when the plain version ran outside the op (arguments are shapes): the
    DFT once (exact) or as 3 bf16-split products (fast), the filterbank as
    3."""
    B, Tp = wavp
    rows = B * ((Tp - KERNEL_N_FFT) // hop + 1)
    dft = 2 * rows * g_a[0] * g_a[1]
    fbank = 2 * rows * fb_hi[0] * fb_hi[1]
    return (1 if precision == "exact" else 3) * dft + 3 * fbank


@log_mel_rows.register_fake
def _log_mel_rows_fake(wavp, g_a, g_b, fb_hi, fb_lo, gpack, fbpack, precision, hop,
                       transposed):
    B, Tp = wavp.shape
    n_frames = (Tp - KERNEL_N_FFT) // hop + 1
    shape = (n_frames, KERNEL_N_MELS, B) if transposed else (B, n_frames, KERNEL_N_MELS)
    return wavp.new_empty(shape, dtype=torch.float32)


def log_mel(wav: torch.Tensor, config: FrontendConfig | None = None,
            precision: str = "exact", layout: str = "bft",
            framing: str = "auto") -> torch.Tensor:
    """(B, T) waveform (float32 or int16 PCM) -> log-mel dB, fused.

    Drop-in for frontend.mel.log_mel_spectrogram, top_db_mode included.
    layout: 'bft' -> (B, n_mels, n_frames); 'btf' -> (B, n_frames, n_mels),
    the row kernel's own layout; 'tfb' -> (n_frames, n_mels, B), the
    transposed kernel's layout (batches below TFB_MIN_BATCH take the row
    kernel and transpose its output). framing ('auto' | 'slices' |
    'gather') chose an XLA lowering in the JAX package; the kernel reads
    frames straight from the padded wave, so all three give the same output.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
    """
    if precision not in ("exact", "fast"):
        raise ValueError(f"unknown precision {precision!r}; expected 'exact' or 'fast'")
    if layout not in ("bft", "btf", "tfb"):
        raise ValueError(f"unknown layout {layout!r}; expected 'bft', 'btf' or 'tfb'")
    if framing not in ("auto", "slices", "gather"):
        raise ValueError(f"unknown framing {framing!r}; expected 'auto', 'slices' "
                         f"or 'gather'")
    config = config or FrontendConfig()
    if config.n_fft != KERNEL_N_FFT or config.n_mels != KERNEL_N_MELS:
        raise ValueError(f"the mel kernel is built for n_fft={KERNEL_N_FFT}, "
                         f"n_mels={KERNEL_N_MELS}; got {config.n_fft}, {config.n_mels}")
    if wav.dtype not in (torch.float32, torch.int16) or wav.dim() != 2:
        raise ValueError(f"log_mel takes (B, T) float32 or int16, got "
                         f"{tuple(wav.shape)} {wav.dtype}")
    B = wav.shape[0]
    wavp = reflect_pad(wav, config.n_fft // 2) if config.center else wav
    wavp = wavp.contiguous()
    mats = _matrices(config, wav.dtype == torch.int16, precision, wav.device)
    transposed = layout == "tfb" and B >= TFB_MIN_BATCH
    if wav.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {wav.device}")
    mel = log_mel_rows(wavp, *mats, precision, config.hop_length, transposed)
    if layout == "tfb":
        x_db = mel if transposed else mel.permute(1, 2, 0)
        per_sample_dims = (0, 1)
    else:
        x_db = mel if layout == "btf" else mel.transpose(-1, -2)
        per_sample_dims = (-2, -1)
    if config.top_db is not None:
        if config.top_db_mode == "torch":
            ref = global_max(x_db.max())
        elif config.top_db_mode == "per_sample":
            ref = x_db.amax(dim=per_sample_dims, keepdim=True)
        else:
            raise ValueError(f"unknown top_db_mode {config.top_db_mode!r}")
        x_db = torch.maximum(x_db, ref - config.top_db)
    return x_db


def make_frontend_fn(config: FrontendConfig | None = None, use_kernel: bool = True,
                     precision: str = "exact", layout: str = "bft"):
    """Frontend callable for models.*.forward(frontend_fn=...).

    use_kernel=True: the fused log_mel (kernel on CUDA tensors, its plain
    version on CPU tensors); False: the rfft reference frontend.
    layout 'btf'/'tfb' must pair with a model config of the same mel_layout.
    layout 'tfb_to_bft' gives the canonical (B, F, T) mel for a 'bft'
    consumer such as the PSL teacher, through the transposed kernel plus
    one transpose where that is bitwise the row kernel (precision 'fast'
    and B >= TFB_MIN_BATCH, as in the JAX package), else through the row
    kernel; without the kernel it is the plain 'bft' chain."""
    if layout not in ("bft", "btf", "tfb", "tfb_to_bft"):
        raise ValueError(f"unknown frontend layout {layout!r}; expected one of "
                         f"'bft', 'btf', 'tfb', 'tfb_to_bft'")
    config = config or FrontendConfig()
    if use_kernel and layout == "tfb_to_bft":
        def fe(wav):
            if precision != "fast" or wav.shape[0] < TFB_MIN_BATCH:
                return log_mel(wav, config, precision=precision, layout="bft")
            return log_mel(wav, config, precision=precision, layout="tfb").permute(2, 1, 0)

        return fe
    if use_kernel:
        return lambda wav: log_mel(wav, config, precision=precision, layout=layout)
    if layout == "btf":
        return lambda wav: log_mel_spectrogram(wav, config).transpose(-1, -2)
    if layout == "tfb":
        return lambda wav: log_mel_spectrogram(wav, config).permute(2, 1, 0)
    return lambda wav: log_mel_spectrogram(wav, config)  # 'bft'/'tfb_to_bft'
