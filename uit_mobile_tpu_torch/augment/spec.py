"""Spectrogram masking, counterpart of ``uit_mobile_tpu/augment/spec.py``.

torchaudio's mask_along_axis_iid semantics on the dB mel: draw a width
value ~ U[0, param) and a start min_value ~ U[0, length - value), floor
both, and mask the whole bins [floor(min_value), floor(min_value) +
floor(value)) with ``mask_value``; one mask per sample with ``iid_masks``.
The draws do not depend on the layout, so a 'tfb' (T, F, B) result is
bitwise the 'bft' (B, F, T) result transposed for the same generator state.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch


def _axis_mask(generator, batch: int, length: int, mask_param, iid: bool, device):
    """(batch or 1, length) bool, True where masked."""
    n = batch if iid else 1
    value = torch.rand(n, generator=generator, device=device) * float(mask_param)
    min_value = torch.rand(n, generator=generator, device=device) * (length - value)
    start = torch.floor(min_value)
    end = start + torch.floor(value)
    pos = torch.arange(length, device=device)[None, :]
    return (pos >= start[:, None]) & (pos < end[:, None])


def time_masking(generator, spec, time_mask_param=20, iid_masks=True,
                 mask_value=0.0, layout="bft"):
    """spec: (B, F, T) for 'bft' or (T, F, B) for 'tfb'."""
    if layout == "tfb":
        T, _, B = spec.shape
        mask = _axis_mask(generator, B, T, time_mask_param, iid_masks, spec.device)
        return torch.where(mask.T[:, None, :], mask_value, spec)
    B, _, T = spec.shape
    mask = _axis_mask(generator, B, T, time_mask_param, iid_masks, spec.device)
    return torch.where(mask[:, None, :], mask_value, spec)


def frequency_masking(generator, spec, freq_mask_param=8, iid_masks=True,
                      mask_value=0.0, layout="bft"):
    if layout == "tfb":
        _, F, B = spec.shape
        mask = _axis_mask(generator, B, F, freq_mask_param, iid_masks, spec.device)
        return torch.where(mask.T[None, :, :], mask_value, spec)
    B, F, _ = spec.shape
    mask = _axis_mask(generator, B, F, freq_mask_param, iid_masks, spec.device)
    return torch.where(mask[:, :, None], mask_value, spec)


SPEC_TRANSFORMS = {
    "TimeMasking": time_masking,
    "FrequencyMasking": frequency_masking,
}


def parse_spectransforms(transforms, layout: str = "bft") -> Optional[Callable]:
    """List [{name: kwargs}] or dict {name: kwargs} -> fn(generator, spec),
    or None when there are none. ``layout`` is the mel orientation the
    model trains in ('bft' or 'tfb'); the callable carries it as
    ``.layout`` so the model can refuse a mismatched pairing."""
    if layout not in ("bft", "tfb"):
        raise ValueError(f"spec transforms support 'bft'/'tfb', got {layout!r}")
    if isinstance(transforms, dict):
        items = list(transforms.items())
    elif isinstance(transforms, (list, tuple)):
        items = [kv for entry in transforms for kv in entry.items()]
    elif transforms is None:
        items = []
    else:
        raise ValueError(f"bad spectransforms {transforms!r}")
    for name, _ in items:
        if name not in SPEC_TRANSFORMS:
            raise KeyError(f"unknown spec transform {name!r}; known: {sorted(SPEC_TRANSFORMS)}")
    fns = [functools.partial(SPEC_TRANSFORMS[name], layout=layout, **(kw or {}))
           for name, kw in items]
    if not fns:
        return None

    def apply(generator, spec):
        for fn in fns:
            spec = fn(generator, spec)
        return spec

    apply.layout = layout
    return apply
