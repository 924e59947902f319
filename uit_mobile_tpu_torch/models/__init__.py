"""Model registry: explicit name -> config factory, plus build/apply.

Counterpart of ``uit_mobile_tpu/models/__init__.py``: the UiT family,
MobileNetV2 and the MoE UiT (which, as in the JAX package, has no framewise
forward).
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from . import mobilenetv2, moe, uit
from .mobilenetv2 import MobileNetV2, MobileNetV2Config
from .moe import MoEUiT, MoEUITConfig, uit_xs_moe
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
    "MobileNetV2": mobilenetv2.mobilenetv2,
    "uit_xs_moe": uit_xs_moe,
}
# config type -> (module class, init, forward, framewise forward)
_FAMILIES = {
    UITConfig: (UiT, uit.init, uit.forward, uit.forward_framewise),
    MobileNetV2Config: (MobileNetV2, mobilenetv2.init, mobilenetv2.forward,
                        mobilenetv2.forward_framewise),
    MoEUITConfig: (MoEUiT, moe.init, moe.forward, None),
}


def get_model_config(name: str, **kwargs):
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model {name!r}; known: {sorted(MODEL_REGISTRY)}")
    return MODEL_REGISTRY[name](**kwargs)


def _family(cfg):
    if type(cfg) not in _FAMILIES:
        raise NotImplementedError(f"config type {type(cfg).__name__} is not yet ported")
    return _FAMILIES[type(cfg)]


def module_class(cfg):
    """The parameter-container class of a config (UiT, MobileNetV2, MoEUiT)."""
    return _family(cfg)[0]


def build(cfg, generator: torch.Generator | None = None, device="cuda"):
    """A freshly initialised model on ``device`` (drawn on the CPU from
    ``generator``, default seed 0, so every device gets the same weights),
    in eval mode."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return _family(cfg)[1](cfg, generator).to(dev).eval()


def _refuse_data_shards(model) -> None:
    """A model placed by FSDP (``parallel.fsdp_shard_params`` or
    ``hybrid_shard_params``: ``model.fsdp_axis``, ``model.shards``) holds
    only this rank's 'data' shards of its large tensors; its programs read
    them whole (``model.reads_whole``) through one all-gather. Run on the
    shards themselves, a forward would fail on a shape, so refuse it."""
    axis = getattr(model, "fsdp_axis", None)
    if axis is None or getattr(model, "reads_whole", False):
        return
    if any(a == axis for entries in getattr(model, "shards", {}).values() for _, a, _ in entries):
        raise ValueError(
            f"this {type(model).__name__} holds only its rank's '{axis}' shards (an FSDP "
            f"placement): run its eval forward through parallel.fsdp_forward, and its steps "
            f"with rows=")


def forward(cfg, model, wav: torch.Tensor, **kwargs):
    """The forward of any ported config, in the caller's grad mode: eval
    -> probs, ``train=True`` -> (probs, new_state). A model FSDP placed
    reads its whole tensors through ``parallel.fsdp_forward`` (or a step),
    and is refused here otherwise."""
    _refuse_data_shards(model)
    return _family(cfg)[2](cfg, model, wav, **kwargs)


def apply(cfg, model, wav: torch.Tensor, train: bool = False, **kwargs):
    """Eval forward under ``torch.inference_mode`` -> probs; with
    ``train=True`` the train forward with autograd -> (probs, new_state),
    the running statistics after this batch keyed by buffer name (write
    them back with ``load_state``), as the JAX ``models.apply`` returns
    (probs, new_state)."""
    if train:
        return forward(cfg, model, wav, train=True, **kwargs)
    with torch.inference_mode():
        return forward(cfg, model, wav, **kwargs)


def apply_framewise(cfg, model, wav: torch.Tensor, **kwargs):
    """Temporal tagging under ``torch.inference_mode`` -> (probs (B, S, C),
    times (S, 2) float64 numpy seconds). TypeError for a family without a
    framewise forward (the MoE)."""
    framewise = _family(cfg)[3]
    if framewise is None:
        raise TypeError(f"unknown config type {type(cfg)} for framewise tagging")
    _refuse_data_shards(model)
    with torch.inference_mode():
        return framewise(cfg, model, wav, **kwargs)


@torch.no_grad()
def load_state(model, new_state: dict) -> None:
    """Write a train forward's new_state into the model's buffers."""
    buffers = dict(model.named_buffers())
    for name, value in new_state.items():
        buffers[name].copy_(value)


__all__ = [
    "MODEL_REGISTRY",
    "PRETRAINED_CHECKPOINTS",
    "MobileNetV2",
    "MobileNetV2Config",
    "MoEUITConfig",
    "MoEUiT",
    "UITConfig",
    "UiT",
    "apply",
    "apply_framewise",
    "build",
    "forward",
    "get_model_config",
    "load_state",
    "module_class",
]
