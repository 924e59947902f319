"""Expert parallelism and the MoE train step, counterpart of
``uit_mobile_tpu/parallel/ep.py``: the MoE expert banks (models/moe.py)
sharded over an 'expert' mesh axis.

The scaling path for the MoE variant: its parameters grow with n_experts
while each rank stores and computes n_experts / n_shards banks. Every
``moe.fc1``/``moe.fc2`` leaf is sharded on its leading (E,) axis; the
router and the dense trunk are replicated. JAX's GSPMD partitions the
expert einsum and inserts GShard's pair of all-to-alls. The port computes
the same function another way: each expert rank routes all the tokens of
its data rows, runs its own banks on the slots they fill, and one
all-reduce over 'expert' a block sums the combine (``moe.moe_mlp`` with
``MoE.ep``). On a ('data', 'expert') mesh the batch shards over 'data';
the routing groups are the global batch's, so their choices are gathered
over 'data'.

``make_moe_train_step`` is the BCE + router-aux step; on the sharded banks
(``ep_shard_params``, ``tp.sharded_opt_init``) with ``rows`` over the
'data' group it is the replicated step on the global batch.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .mesh import GridMesh
from .rows import Rows, sharded
from .tp import make_mesh_2d, place_params


@dataclasses.dataclass(frozen=True)
class ExpertShard:
    """One rank's share of an MoE block's banks: experts [first, first + its
    local count), the others on the ranks of ``group``."""
    first: int
    group: object


def make_expert_mesh(n_data: int, n_expert: int, axes: tuple = ("data", "expert"),
                     device="cuda") -> GridMesh:
    """The process group as an (n_data x n_expert) mesh, 'expert' innermost
    (the combine's all-reduce rides adjacent ranks)."""
    return make_mesh_2d(n_data, n_expert, axes=axes, device=device)


def ep_param_specs(params, *, expert_axis: str = "expert") -> dict:
    """name -> spec: every ``moe.fc1/fc2`` leaf sharded on its leading (E,)
    axis; the router and the dense trunk replicated ()."""
    from .tp import _named

    def spec(name, ndim):
        keys = name.split(".")
        if "moe" in keys and ("fc1" in keys or "fc2" in keys):
            return (expert_axis,) + (None,) * (ndim - 1)
        return ()

    return {name: spec(name, len(shape)) for name, shape in _named(params)}


def ep_shard_params(mesh: GridMesh, model, *, expert_axis: str = "expert"):
    """Keep this rank's expert banks in place (an expert count the axis does
    not divide stays whole) -> (model, fitted specs); build the optimizer
    afterwards (``tp.sharded_opt_init``)."""
    model, fitted = place_params(mesh, model, ep_param_specs(model, expert_axis=expert_axis),
                                 axes=(expert_axis,))
    for name, mod in model.named_modules():
        if name.endswith("moe") and f"{name}.fc1.kernel" in model.shards:
            mod.ep = ExpertShard(mesh.coords[expert_axis] * mod.fc1.kernel.shape[0],
                                 mesh.group(expert_axis))
    return model, fitted


def expert_parallel_forward(cfg, model, mesh: GridMesh, *, data_axis: str = "data",
                            expert_axis: str = "expert",
                            frontend_fn: Optional[Callable] = None) -> Callable:
    """The MoE eval forward with the expert banks sharded over
    ``mesh[expert_axis]`` (``model`` in place) and the batch over
    ``data_axis`` -> ``fn(wav)``: every rank passes the global batch and
    gets the global probabilities. ``frontend_fn``: the kernel frontend.
    On an NCCL mesh on the card, a CUDA graph per batch shape
    (``GridMesh.dispatch``: ``fn.eager``, ``fn.graphs``)."""
    from ..models import moe

    model, _ = ep_shard_params(mesh, model, expert_axis=expert_axis)

    def body(wav):
        local, rows = mesh.shard_rows(wav, data_axis)
        with torch.inference_mode(), sharded(rows):
            probs = moe.forward(cfg, model, local, frontend_fn=frontend_fn)
        return mesh.gather_rows(probs, data_axis)

    return mesh.dispatch(body)


def make_moe_train_step(cfg, model, optimizer, *, frontend_fn: Optional[Callable] = None,
                        rows: Optional[Rows] = None) -> Callable:
    """BCE + router-aux train step for the MoE variant: ``step(wav, target,
    generator=None) -> {'total_loss', 'bce', 'aux', 'grad_norm'}``, which
    updates ``model`` (its parameters and init_bn running statistics) and
    ``optimizer`` in place, as the port's other steps do.

    Runs the train-mode forward (``moe.forward_with_aux(train=True)``): the
    init_bn normalizes on batch statistics and its updated running
    statistics are written back (training through the eval forward would
    leave them at their init); ``generator`` drives dropout and drop-path
    where the config enables them. ``grad_norm`` is the global norm of the
    gradients before the update (no clipping, as in the JAX step).
    ``rows``: the batch is this rank's share of a global batch over the
    'data' group (``parallel.rows``), and the step is the global batch's.
    ``model`` may be placed by EP (``ep_shard_params``) or FSDP
    (``fsdp_shard_params``, then ``rows=`` is required): the FSDP step
    gathers the shards before the forward and reduce-scatters their
    gradients on its device side, as ``train.steps.make_train_step`` does.

    Dispatched as ``train/steps.py``'s steps are: the host plans the
    micro-step, the device side is a CUDA graph per batch shape and
    optimizer kind on the card (one process, or a mesh on NCCL: the
    combine's and the routing's collectives in the graph), eager on the CPU
    and on gloo. The capacity and the drop-path rates are Python values of the
    config, and the routing (a stable sort, integer slot maps) reads no device
    value on the host. ``make_multi_step`` takes the step, its batches
    ``{'wav', 'target'}``."""
    from ..models import moe
    from ..train.steps import (_data_shards, _placed_forward, dispatch_step, make_loss,
                               update_from_loss, with_device_side)

    bce_loss = make_loss("BCELoss")  # the reference-parity clamped BCE
    shards = _data_shards(model, optimizer, rows)

    def device_step(batch, generator, kind, row):
        with sharded(rows):
            (probs, aux, new_state), gathered = _placed_forward(
                shards, optimizer, moe.forward_with_aux, cfg, model, batch["wav"], train=True,
                generator=generator, frontend_fn=frontend_fn)
            bce = bce_loss(probs, batch["target"])
            loss = bce + cfg.router_aux_weight * aux
            gnorm = update_from_loss(model, optimizer, loss, new_state, plan=(kind, row),
                                     gathered=gathered)
        return {"total_loss": loss.detach(), "bce": bce.detach(), "aux": aux.detach(),
                "grad_norm": gnorm}

    batch_step = dispatch_step(device_step, optimizer, rows)

    def step(wav: torch.Tensor, target: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> dict:
        return batch_step({"wav": wav, "target": target}, generator)

    return with_device_side(step, batch_step)
