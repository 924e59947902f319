"""Parallelism, counterpart of ``uit_mobile_tpu/parallel``. Only the MoE
train step of ``ep.py`` is ported so far; the sharded layouts are
ROADMAP §A17."""

from .ep import make_moe_train_step

__all__ = ["make_moe_train_step"]
