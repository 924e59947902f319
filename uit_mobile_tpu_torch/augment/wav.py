"""Waveform augmentations, counterpart of ``uit_mobile_tpu/augment/wav.py``.

The three transforms the shipped configs use (``configs/train_uit_xs.yaml``),
with torch_audiomentations' defaults, each applied per sample with
probability ``p`` and drawn from an explicit ``torch.Generator``:

- Shift(min_shift=-0.5, max_shift=0.5): circular time shift by a random
  fraction of the clip length;
- Gain(min_gain_in_db=-18, max_gain_in_db=6): random gain;
- PolarityInversion: sign flip.

They expect normalized float32 waves (the train step restores that
convention whenever a wav augment is configured).
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from ..parallel.rows import rand_rows


def _uniform(generator, n: int, lo: float, hi: float, device) -> torch.Tensor:
    return lo + (hi - lo) * rand_rows(generator, (n,), device)


def _bernoulli(generator, n: int, p: float, device) -> torch.Tensor:
    return rand_rows(generator, (n,), device) < p


def shift(generator, wav, min_shift=-0.5, max_shift=0.5, p=0.5):
    """Per-sample circular shift by round(frac * T) samples."""
    B, T = wav.shape[0], wav.shape[-1]
    apply = _bernoulli(generator, B, p, wav.device)
    frac = _uniform(generator, B, min_shift, max_shift, wav.device)
    n = torch.where(apply, torch.round(frac * T).long(), 0)
    idx = (torch.arange(T, device=wav.device)[None, :] - n[:, None]) % T
    return torch.gather(wav, -1, idx)


def gain(generator, wav, min_gain_in_db=-18.0, max_gain_in_db=6.0, p=0.5):
    B = wav.shape[0]
    apply = _bernoulli(generator, B, p, wav.device)
    db = _uniform(generator, B, min_gain_in_db, max_gain_in_db, wav.device)
    g = torch.where(apply, 10.0 ** (db / 20.0), 1.0)
    return wav * g[:, None]


def polarity_inversion(generator, wav, p=0.5):
    apply = _bernoulli(generator, wav.shape[0], p, wav.device)
    return wav * torch.where(apply, -1.0, 1.0)[:, None]


# the wav transforms that keep every sample at its time (SED's per-segment
# targets stay aligned): not Shift
TIME_PRESERVING_WAV_TRANSFORMS = frozenset({"Gain", "PolarityInversion"})

WAV_TRANSFORMS = {
    "Shift": shift,
    "Gain": gain,
    "PolarityInversion": polarity_inversion,
}


def parse_wavtransforms(transforms_dict: Optional[dict]) -> Optional[Callable]:
    """Config dict {name: kwargs} -> fn(generator, wav) applying them in
    order, or None when there are none."""
    fns = []
    for name, kwargs in (transforms_dict or {}).items():
        if name not in WAV_TRANSFORMS:
            raise KeyError(f"unknown wav transform {name!r}; known: {sorted(WAV_TRANSFORMS)}")
        fns.append(functools.partial(WAV_TRANSFORMS[name], **(kwargs or {})))
    if not fns:
        return None

    def apply(generator, wav):
        for fn in fns:
            wav = fn(generator, wav)
        return wav

    return apply
