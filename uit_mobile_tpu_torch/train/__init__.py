from .loop import Trainer, train_from_config
from .schedule import cosine_with_warmup
from .steps import (Optimizer, OptimizerSpec, build_optimizer, find_ema_params, make_eval_step,
                    make_framewise_train_step, make_loss, make_multi_step, make_train_step,
                    params_ema, wrap_optimizer)

__all__ = [
    "Optimizer",
    "OptimizerSpec",
    "Trainer",
    "build_optimizer",
    "cosine_with_warmup",
    "find_ema_params",
    "make_eval_step",
    "make_framewise_train_step",
    "make_loss",
    "make_multi_step",
    "make_train_step",
    "params_ema",
    "train_from_config",
    "wrap_optimizer",
]
