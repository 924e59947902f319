"""Host-side WAV I/O built on the stdlib ``wave`` module.

Replaces ``torchaudio.load`` (reference ``inference.py:52``) for 16-bit PCM
files. Audio I/O stays on the host; only batched waveforms reach the
device. A copy of ``uit_mobile_tpu/data/audio_io.py``, kept here so the port
imports nothing of the JAX package. Scaling matches the reference's HDF5 pipeline (int16 / 32768, see
reference ``dataset.py:44-45``) and torchaudio.load's int16 normalization.
"""

from __future__ import annotations

import io
import wave
from pathlib import Path

import numpy as np


def _decode(f: wave.Wave_read, origin) -> tuple[np.ndarray, int]:
    n_channels = f.getnchannels()
    sampwidth = f.getsampwidth()
    sr = f.getframerate()
    raw = f.readframes(f.getnframes())
    if sampwidth == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif sampwidth == 3:  # 24-bit: widen to int32 via a zeroed low byte
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        widened = np.zeros((b.shape[0], 4), dtype=np.uint8)
        widened[:, 1:] = b
        data = widened.view("<i4").reshape(-1).astype(np.float32) / 2147483648.0
    elif sampwidth == 1:  # unsigned 8-bit
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {sampwidth} in {origin}")
    data = data.reshape(-1, n_channels).T  # (channels, T)
    return np.ascontiguousarray(data), sr


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 waveform (channels, T) in [-1, 1), sr)."""
    with wave.open(str(path), "rb") as f:
        return _decode(f, path)


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode an in-memory RIFF/WAV blob (e.g. an HTTP request body)."""
    with wave.open(io.BytesIO(data), "rb") as f:
        return _decode(f, "<bytes>")


def write_wav(path, data: np.ndarray, sample_rate: int = 16000) -> None:
    """Write float32 (T,) or (channels, T) data as 16-bit PCM."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[None, :]
    pcm = np.clip(data * 32768.0, -32768, 32767).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(pcm.shape[0])
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.T.tobytes())
