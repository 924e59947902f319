"""The MoE train step of ``uit_mobile_tpu/parallel/ep.py``.

The JAX module also shards the expert banks over an 'expert' mesh axis
(``make_expert_mesh``, ``ep_param_specs``, ``ep_shard_params``,
``expert_parallel_forward``); that half waits for the port's parallelism
(ROADMAP §A17). ``make_moe_train_step`` is the single-device step.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import moe


def make_moe_train_step(cfg, model, optimizer, *,
                        frontend_fn: Optional[Callable] = None) -> Callable:
    """BCE + router-aux train step for the MoE variant: ``step(wav, target,
    generator=None) -> {'total_loss', 'bce', 'aux', 'grad_norm'}``, which
    updates ``model`` (its parameters and init_bn running statistics) and
    ``optimizer`` in place, as the port's other steps do.

    Runs the train-mode forward (``moe.forward_with_aux(train=True)``): the
    init_bn normalizes on batch statistics and its updated running
    statistics are written back (training through the eval forward would
    leave them at their init); ``generator`` drives dropout and drop-path
    where the config enables them. ``grad_norm`` is the global norm of the
    gradients before the update (no clipping, as in the JAX step)."""
    from ..train.steps import make_loss, update_from_loss

    bce_loss = make_loss("BCELoss")  # the reference-parity clamped BCE

    def step(wav: torch.Tensor, target: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        probs, aux, new_state = moe.forward_with_aux(cfg, model, wav, train=True,
                                                     generator=generator,
                                                     frontend_fn=frontend_fn)
        bce = bce_loss(probs, target)
        loss = bce + cfg.router_aux_weight * aux
        gnorm = update_from_loss(model, optimizer, loss, new_state)
        return {"total_loss": loss.detach(), "bce": bce.detach(), "aux": aux.detach(),
                "grad_norm": gnorm}

    return step
