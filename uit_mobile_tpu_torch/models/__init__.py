"""Model registry: explicit name -> config factory, plus build/apply.

Counterpart of ``uit_mobile_tpu/models/__init__.py`` for the UiT family.
MobileNetV2 and the MoE UiT are not yet ported and raise.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from . import uit
from .uit import (
    PRETRAINED_CHECKPOINTS,
    UiT,
    UITConfig,
    audio_transformer_h128_d4_m3,
    audio_transformer_h128_d4_m3_relu,
    audio_transformer_h128_d6_m3,
    audio_transformer_h128_d6_m3_relu,
    uit_xs,
    uit_xxs,
    uit_xxxs,
)

MODEL_REGISTRY = {
    "uit_xs": uit_xs,
    "uit_xxs": uit_xxs,
    "uit_xxxs": uit_xxxs,
    "audio_transformer_h128_d4_m3": audio_transformer_h128_d4_m3,
    "audio_transformer_h128_d4_m3_relu": audio_transformer_h128_d4_m3_relu,
    "audio_transformer_h128_d6_m3": audio_transformer_h128_d6_m3,
    "audio_transformer_h128_d6_m3_relu": audio_transformer_h128_d6_m3_relu,
}
NOT_YET_PORTED = ("MobileNetV2", "uit_xs_moe")


def get_model_config(name: str, **kwargs) -> UITConfig:
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model {name!r} is not yet ported")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


def build(cfg, generator: torch.Generator | None = None, device="cuda") -> UiT:
    """A freshly initialised model on ``device`` (drawn on the CPU from
    ``generator``, default seed 0, so every device gets the same weights)."""
    if not isinstance(cfg, UITConfig):
        raise NotImplementedError(f"config type {type(cfg).__name__} is not yet ported")
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return uit.init(cfg, generator).to(dev).eval()


def apply(cfg, model: UiT, wav: torch.Tensor, **kwargs) -> torch.Tensor:
    """Eval forward for any ported model config."""
    if not isinstance(cfg, UITConfig):
        raise NotImplementedError(f"config type {type(cfg).__name__} is not yet ported")
    with torch.inference_mode():
        return uit.forward(cfg, model, wav, **kwargs)


__all__ = [
    "MODEL_REGISTRY",
    "PRETRAINED_CHECKPOINTS",
    "UITConfig",
    "UiT",
    "apply",
    "build",
    "get_model_config",
]
