"""ctypes bindings for libuitdata, the native host data plane, counterpart
of ``uit_mobile_tpu/native``: a RIFF/WAV parser, int16 -> float32
conversion, multithreaded padded-batch assembly and the multi-hot scatter.

The library is built from ``uitdata.cc`` with ``g++`` at first use into
``uit_mobile_tpu_torch/_build/native/`` (``build.py``). Where the JAX
package falls back to numpy quietly when its library is missing, a failed
build or load here raises, naming the command: ``data/hdf5.py:collate``
takes this path under the JAX package's rule, and a batch on it is
assembled here or not at all. ``available()`` asks whether the library
builds and loads. ``calls`` counts each function's calls into the library.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Sequence

import numpy as np

_lib = None
_lock = threading.Lock()
calls = {"parse_wav16": 0, "read_wav": 0, "pad_batch": 0, "multihot": 0}


def _load() -> ctypes.CDLL:
    """The loaded library, built first where needed; raises on failure."""
    global _lib
    with _lock:
        if _lib is None:
            from .build import build

            path = build()
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise RuntimeError(f"loading the native data plane {path} failed ({e}); "
                                   f"rebuild it with `python -m "
                                   f"uit_mobile_tpu_torch.native.build --force`") from e
            lib.uit_parse_wav16.restype = ctypes.c_int
            lib.uit_parse_wav16.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_int16)),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int32),
            ]
            for name in ("uit_pcm16_to_f32", "uit_pad_batch_pcm16", "uit_pad_batch_f32",
                         "uit_pad_batch_i16", "uit_multihot"):
                getattr(lib, name).restype = None
            lib.uit_version.restype = ctypes.c_int32
            _lib = lib
        return _lib


def _count(name: str) -> None:
    with _lock:
        calls[name] += 1


def available() -> bool:
    """Whether the library builds and loads in this process."""
    try:
        _load()
    except RuntimeError:
        return False
    return True


def parse_wav16_native(buf: bytes):
    """Zero-copy RIFF parse of an in-memory blob -> (rc, pcm int16 view or
    None, channels, sample_rate). rc: 0 ok, 1 bad header, 2 no fmt before
    data, 3 unsupported codec, 4 no data chunk (uitdata.cc), 5 parsed but
    zero frames or channels (given here, so callers have one success
    condition). On rc 0 the array views ``buf`` (the caller keeps it
    alive). Lying chunk lengths clamp to the buffer and truncated chunks end
    the walk."""
    lib = _load()
    _count("parse_wav16")
    data_ptr = ctypes.POINTER(ctypes.c_int16)()
    frames, channels, sr = ctypes.c_int64(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.uit_parse_wav16(buf, len(buf), ctypes.byref(data_ptr), ctypes.byref(frames),
                             ctypes.byref(channels), ctypes.byref(sr))
    if rc != 0 or channels.value <= 0 or frames.value <= 0:
        return (rc if rc != 0 else 5), None, channels.value, sr.value
    pcm = np.ctypeslib.as_array(data_ptr, shape=(frames.value * channels.value,))
    return 0, pcm, channels.value, sr.value


def read_wav_native(path) -> tuple[np.ndarray, int]:
    """RIFF parse + int16 -> float32 in the library -> ((channels, T)
    float32, sr). A file the parser does not take (not 16-bit PCM, or a
    malformed header) goes to ``data.audio_io.read_wav``, which reads the
    other formats and raises on a malformed file, as the JAX package does."""
    buf = Path(path).read_bytes()
    rc, pcm, channels, sr = parse_wav16_native(buf)
    if rc != 0:
        from ..data.audio_io import read_wav

        return read_wav(path)
    _count("read_wav")
    out = np.empty(pcm.shape[0], dtype=np.float32)
    _load().uit_pcm16_to_f32(pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
                             out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                             ctypes.c_int64(pcm.shape[0]))
    return out.reshape(-1, channels).T.copy(), sr


def pad_batch_native(waves: Sequence[np.ndarray], threads: int = 4):
    """Right-zero-padded (B, max_len) batch by native threads -> (batch,
    int32 lengths), as ``data.hdf5.pad_batch``: int16 clips give an int16
    batch, any other dtype float32."""
    if not waves:
        raise ValueError("pad_batch_native: empty batch")
    if any(w.ndim != 1 for w in waves):
        # the C copy reads lengths[i] contiguous samples: a (C, T) clip
        # would keep channel 0 alone
        raise ValueError("pad_batch_native: clips must be 1-D (T,) mono waveforms")
    pcm16 = waves[0].dtype == np.int16
    if not all((w.dtype == np.int16) == pcm16 for w in waves):
        raise ValueError("pad_batch_native: mixed int16/float waveforms in one batch")
    lib = _load()
    _count("pad_batch")
    lengths = np.asarray([w.shape[-1] for w in waves], dtype=np.int64)
    b, max_len = len(waves), int(lengths.max())
    dtype = np.int16 if pcm16 else np.float32
    ctype = ctypes.c_int16 if pcm16 else ctypes.c_float
    out = np.empty((b, max_len), dtype=dtype)
    contig = [np.ascontiguousarray(w, dtype=dtype) for w in waves]
    ptrs = (ctypes.POINTER(ctype) * b)(*[w.ctypes.data_as(ctypes.POINTER(ctype))
                                         for w in contig])
    fn = lib.uit_pad_batch_i16 if pcm16 else lib.uit_pad_batch_f32
    fn(ptrs, lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), ctypes.c_int64(b),
       ctypes.c_int64(max_len), out.ctypes.data_as(ctypes.POINTER(ctype)),
       ctypes.c_int32(threads))
    return out, lengths.astype(np.int32)


def multihot_batch_native(label_lists: Sequence[Sequence[int]], n_classes: int) -> np.ndarray:
    """(B, n_classes) float32 multi-hot of each row's labels; labels outside
    [0, n_classes) are dropped (the collate side of already-validated
    lists; ``data.manifest.multihot`` raises on them instead)."""
    lib = _load()
    _count("multihot")
    b = len(label_lists)
    offsets = np.zeros(b + 1, dtype=np.int64)
    flat: list = []
    for i, labs in enumerate(label_lists):
        flat.extend(int(x) for x in labs)
        offsets[i + 1] = len(flat)
    flat_arr = np.asarray(flat, dtype=np.int32)
    out = np.empty((b, n_classes), dtype=np.float32)
    lib.uit_multihot(flat_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                     offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     ctypes.c_int64(b), ctypes.c_int32(n_classes),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


__all__ = ["available", "multihot_batch_native", "pad_batch_native", "parse_wav16_native",
           "read_wav_native"]
