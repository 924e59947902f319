"""Plain PyTorch log-mel frontend with torchaudio-0.13 numerics.

The reference DSP stage of the port, counterpart of
``uit_mobile_tpu/frontend/mel.py``: reflect-padded framing, periodic Hann
window, ``torch.fft.rfft`` power spectrum, the float32 HTK filterbank
(``norm=None``) and ``AmplitudeToDB(top_db=120)``. The fused CUDA kernel in
``uit_mobile_tpu_torch/ops/mel.py`` is held against this module.

- ``top_db_mode='torch'`` replicates torchaudio's batch-global max for
  inputs of 3 or fewer dims; ``'per_sample'`` clamps each clip against its
  own max.
- int16 PCM is accepted and normalised by 1/32768 (an exact power-of-two
  scale), so int16 input is bitwise the same as ``wav.float() / 32768``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..parallel.rows import global_max


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """Log-mel frontend hyperparameters (defaults = reference uit.py:287-307)."""

    sample_rate: int = 16000
    n_fft: int = 512
    win_length: int = 512
    hop_length: int = 160
    n_mels: int = 64
    f_min: float = 0.0
    f_max: float = 8000.0
    center: bool = True
    top_db: float = 120.0
    # 'torch'      : replicate torchaudio's batch-global max for 3-D inputs
    # 'per_sample' : clamp each clip against its own max
    top_db_mode: str = "torch"

    @property
    def n_freqs(self) -> int:
        return self.n_fft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        if self.center:
            return 1 + num_samples // self.hop_length
        return 1 + (num_samples - self.n_fft) // self.hop_length


def hann_window_periodic(win_length: int, dtype=np.float32) -> np.ndarray:
    """Periodic Hann window: 0.5 - 0.5*cos(2*pi*k / N), k=0..N-1."""
    k = np.arange(win_length, dtype=np.float64)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * k / win_length)
    return w.astype(dtype)


def padded_window(win_length: int, n_fft: int, dtype=np.float32) -> np.ndarray:
    """Hann window center-padded to n_fft (torch.stft semantics for
    win_length < n_fft: pad (n_fft - win)//2 zeros on each side)."""
    if win_length > n_fft:
        raise ValueError(f"win_length {win_length} > n_fft {n_fft}")
    w = hann_window_periodic(win_length, dtype)
    if win_length == n_fft:
        return w
    left = (n_fft - win_length) // 2
    out = np.zeros(n_fft, dtype=dtype)
    out[left:left + win_length] = w
    return out


def _hz_to_mel_htk(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, dtype=np.float64) / 700.0)


def _mel_to_hz_htk(m):
    return 700.0 * (10.0 ** (np.asarray(m, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_cached(n_freqs, n_mels, sample_rate, f_min, f_max):
    # torchaudio.functional.melscale_fbanks(norm=None, mel_scale='htk')
    # computed in float32 to match torchaudio's default dtype end to end.
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs).astype(np.float32)
    m_min = _hz_to_mel_htk(f_min)
    m_max = _hz_to_mel_htk(f_max)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz_htk(m_pts).astype(np.float32)

    f_diff = f_pts[1:] - f_pts[:-1]                      # (n_mels+1,)
    slopes = f_pts[None, :] - all_freqs[:, None]          # (n_freqs, n_mels+2)
    down = (-1.0 * slopes[:, :-2]) / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    return fb.astype(np.float32)                          # (n_freqs, n_mels)


def mel_filterbank(config: FrontendConfig) -> np.ndarray:
    """(n_freqs, n_mels) triangular HTK filterbank, norm=None."""
    return _mel_filterbank_cached(
        config.n_freqs, config.n_mels, config.sample_rate, config.f_min, config.f_max
    )


def reflect_pad(wav: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., T) -> (..., T + 2*pad), torch.stft's reflect padding: the edge
    sample is not repeated, as with ``F.pad(..., mode="reflect")``, but any
    dtype (int16 included) and any number of leading dims are accepted."""
    if wav.shape[-1] <= pad:
        raise ValueError(
            f"waveform of {wav.shape[-1]} samples is too short for "
            f"reflect padding of {pad}; need > {pad} samples"
        )
    return torch.cat(
        [wav[..., 1:pad + 1].flip(-1), wav, wav[..., -pad - 1:-1].flip(-1)], dim=-1
    )


def frame_signal(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """(..., T) waveform -> (..., n_frames, n_fft) frames (a strided view
    of the reflect-padded wave when ``center``)."""
    if config.center:
        wav = reflect_pad(wav, config.n_fft // 2)
    return wav.unfold(-1, config.n_fft, config.hop_length)


def spectrogram(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Power spectrogram, (..., T) -> (..., n_freqs, n_frames). power=2.0."""
    frames = frame_signal(wav, config)
    window = torch.as_tensor(padded_window(config.win_length, config.n_fft),
                             dtype=frames.dtype, device=wav.device)
    spec = torch.fft.rfft(frames * window, n=config.n_fft, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    return power.transpose(-1, -2)


def amplitude_to_db(power: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """Power -> dB with top_db floor, matching torchaudio AmplitudeToDB."""
    x_db = 10.0 * torch.log10(torch.clamp(power, min=1e-10))
    if config.top_db is not None:
        if config.top_db_mode == "torch":
            # torchaudio packs (B, F, T) as (1, B, F, T) and maxes over
            # (-3,-2,-1): for <=3-D input one global max couples the batch
            if power.dim() <= 3:
                ref = x_db.max()
            else:
                ref = x_db.amax(dim=(-3, -2, -1), keepdim=True)
            ref = global_max(ref)  # over every rank's rows, under rows.sharded
        elif config.top_db_mode == "per_sample":
            ref = x_db.amax(dim=(-2, -1), keepdim=True)
        else:
            raise ValueError(f"unknown top_db_mode {config.top_db_mode!r}")
        x_db = torch.maximum(x_db, ref - config.top_db)
    return x_db


def quantize_pcm16(wav) -> np.ndarray:
    """Host-side float -> raw int16 PCM (round to nearest, clipped); exact
    inverse of normalize_pcm16 for floats that came from int16 PCM."""
    if np.asarray(wav).dtype == np.int16:
        return np.asarray(wav)
    return np.clip(np.rint(np.asarray(wav, np.float32) * 32768.0),
                   -32768, 32767).astype(np.int16)


def normalize_pcm16(wav) -> np.ndarray:
    """Host-side raw int16 PCM -> normalized float32 (exact: /2^15)."""
    w = np.asarray(wav)
    if w.dtype == np.int16:
        return w.astype(np.float32) * (1.0 / 32768.0)
    return np.asarray(w, np.float32)


def log_mel_spectrogram(wav: torch.Tensor, config: FrontendConfig) -> torch.Tensor:
    """(..., T) waveform -> (..., n_mels, n_frames) log-mel in dB, in the
    wave's float dtype (float64 gives a high-precision reference).

    int16 PCM is accepted and normalized by 1/32768 (exact)."""
    if wav.dtype == torch.int16:
        wav = wav.float() * (1.0 / 32768.0)
    power = spectrogram(wav, config)                       # (..., F, TT)
    fb = torch.as_tensor(mel_filterbank(config), dtype=power.dtype, device=wav.device)
    mel = (power.transpose(-1, -2) @ fb).transpose(-1, -2)
    return amplitude_to_db(mel, config)
