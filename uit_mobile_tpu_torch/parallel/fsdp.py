"""Fully-sharded data parallelism, counterpart of
``uit_mobile_tpu/parallel/fsdp.py``: parameters and optimizer moments
sharded over the same axis the batch is (ZeRO-3). Each rank stores 1/N of
every large tensor; FSDP2 (``torch.distributed.fsdp.fully_shard``)
all-gathers the weights around the forward and the backward and
reduce-scatters the gradients to their shards.

- ``fsdp_param_specs``: the largest dim of every tensor of at least
  ``min_size`` elements over the data axis (JAX's rule); smaller tensors
  replicated.
- ``fsdp_shard_params``: fits those specs to the mesh (a dim the axis does
  not divide stays replicated, as JAX's ``_fit_spec``), shards the model
  with ``fully_shard`` and a placement function, and leaves the replicated
  tensors out of FSDP (each rank holds them whole).
- ``make_fsdp_train_step``: the weak train step on the sharded model; the
  port's Optimizer (Adam/AdamW/SGD) updates the shards, so its moments are
  sharded alike. Under ``parallel.rows`` its result is the single-device
  step on the global batch.

The FSDP x TP composition on a ('data', 'model') ``GridMesh``
(``hybrid_param_specs``, ``hybrid_shard_params``): Megatron's pairing over
'model' (parallel/tp.py), then FSDP2 over the 'data' group on each model
rank's TP shards; ``make_fsdp_train_step`` runs on it unchanged, its
reductions over the 'data' group. (The models import this package, so
this module imports the models inside its functions.)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .mesh import GridMesh, Mesh
from .rows import Rows, sharded
from .tp import _named, shard_params, tp_param_specs


def fsdp_param_specs(params, *, axis: str = "data", min_size: int = 1024) -> dict:
    """name -> spec (one entry a dim: ``axis`` or None; () for a tensor
    under ``min_size`` elements, which stays replicated: its all-gather
    would cost more than its storage)."""
    specs = {}
    for name, shape in _named(params):
        if len(shape) == 0 or int(np.prod(shape)) < min_size:
            specs[name] = ()
            continue
        entries = [None] * len(shape)
        entries[int(np.argmax(shape))] = axis
        specs[name] = tuple(entries)
    return specs


def _fit(spec: tuple, shape, n: int) -> tuple:
    """Drop a sharded dim the axis does not divide evenly."""
    return tuple(None if a is not None and shape[i] % n else a for i, a in enumerate(spec))


class FSDPRoot(nn.Module):
    """The FSDP2 unit around a model: ``root(fn, *args)`` runs ``fn(*args)``
    with the model's parameters gathered (the port's forwards are
    functions of the module, not its ``forward``), and its backward
    reduce-scatters their gradients. ``data_group``: the process group
    FSDP shards over (None: every rank)."""

    def __init__(self, model: nn.Module, data_group=None):
        super().__init__()
        self.model = model
        self.data_group = data_group

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)


def _fully_shard(model: nn.Module, fitted: dict, axis: str, device_mesh, data_group=None):
    """FSDP2 over ``device_mesh`` on the dims ``fitted`` names for ``axis``;
    the other parameters stay whole on every rank -> the root."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    dims = {id(p): fitted[k].index(axis) for k, p in model.named_parameters()
            if axis in fitted[k]}
    replicated = {p for k, p in model.named_parameters() if axis not in fitted[k]}
    root = FSDPRoot(model, data_group)
    fully_shard(root, mesh=device_mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=replicated)
    return root


def fsdp_shard_params(mesh: Mesh, model: nn.Module, *, axis: str = "data",
                      min_size: int = 1024):
    """Shard ``model`` in place over the process mesh ``mesh`` per
    ``fsdp_param_specs`` fitted to it -> (root, fitted specs). Build the
    optimizer on ``root.model`` afterwards: its moments then live on the
    shards."""
    if not mesh.spans_processes:
        raise ValueError("fsdp_shard_params shards over a process group's mesh "
                         "(parallel.mesh.process_mesh)")
    from torch.distributed.device_mesh import init_device_mesh

    n = mesh.size
    shapes = dict(_named(model))
    fitted = {k: _fit(s, shapes[k], n) for k, s in fsdp_param_specs(
        model, axis=axis, min_size=min_size).items()}
    device_mesh = init_device_mesh(mesh.devices[0].type, (n,), mesh_dim_names=(axis,))
    return _fully_shard(model, fitted, axis, device_mesh), fitted


def hybrid_param_specs(params, *, data_axis: str = "data", model_axis: str = "model",
                       min_size: int = 1024, shard_attention: bool = False) -> dict:
    """FSDP x TP ("hybrid sharded"): the Megatron pairing of
    ``tp_param_specs`` over ``model_axis``, then the largest still-free dim
    (by the whole shape) of every tensor of at least ``min_size`` elements
    over ``data_axis``. A paired 2-D kernel is sharded on both dims (mlp.fc1
    (D, 4D) -> (data, model)); a TP-replicated large tensor takes the FSDP
    rule; small tensors and the paired 1-D biases keep their TP spec."""
    shapes = dict(_named(params))
    out = {}
    for name, tspec in tp_param_specs(params, model_axis=model_axis,
                                      shard_attention=shard_attention).items():
        shape = shapes[name]
        if len(shape) == 0 or int(np.prod(shape)) < min_size:
            out[name] = tspec
            continue
        entries = list(tspec) + [None] * (len(shape) - len(tspec))
        free = [i for i, e in enumerate(entries) if e is None]
        if free:
            entries[max(free, key=lambda i: shape[i])] = data_axis
        out[name] = tuple(entries)
    return out


def hybrid_shard_params(mesh: GridMesh, model: nn.Module, *, data_axis: str = "data",
                        model_axis: str = "model", min_size: int = 1024,
                        shard_attention: bool = False):
    """Shard ``model`` in place per ``hybrid_param_specs`` fitted to the
    ('data', 'model') ``mesh`` (a dim an axis does not divide stays whole
    there): each rank keeps its Megatron shards over 'model'
    (``tp.shard_params``), and FSDP2's ``fully_shard`` shards those over the
    'data' group -> (root, fitted specs). Build the optimizer on
    ``root.model`` afterwards."""
    from torch.distributed.device_mesh import DeviceMesh

    from .tp import _fit_spec

    specs = hybrid_param_specs(model, data_axis=data_axis, model_axis=model_axis,
                               min_size=min_size, shard_attention=shard_attention)
    fitted = {k: _fit_spec(specs[k], shape, mesh) for k, shape in _named(model)}
    shard_params(mesh, model, model_axis=model_axis, shard_attention=shard_attention)
    model.shard_specs = fitted
    group = mesh.group(data_axis)
    device_mesh = DeviceMesh.from_group(group, mesh.device.type, mesh_dim_names=(data_axis,))
    return _fully_shard(model, fitted, data_axis, device_mesh, group), fitted


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if hasattr(t, "to_local") else t


def make_fsdp_train_step(model_cfg, root: FSDPRoot, optimizer, *, rows: Optional[Rows] = None,
                         loss_name: str = "BCELoss", loss_args: Optional[dict] = None,
                         mixup_alpha: Optional[float] = None,
                         max_grad_norm: Optional[float] = None,
                         wav_augment: Optional[Callable] = None,
                         spec_augment: Optional[Callable] = None,
                         frontend_fn: Optional[Callable] = None) -> Callable:
    """The weak train step (no PSL) of ``train.steps.make_train_step`` on a
    model sharded by ``fsdp_shard_params`` or ``hybrid_shard_params``:
    ``step(batch, generator) -> {'total_loss', 'grad_norm'}``. ``optimizer``
    is the port's Optimizer built on ``root.model`` after sharding; ``rows``
    this rank's share over the data group. The sharded gradients arrive
    averaged over the data group by FSDP's reduce-scatter, the others by an
    all-reduce over it; the pre-clip norm and the clip are the global
    gradient's (the squares of FSDP's and TP's shards summed over their
    groups)."""
    import torch.distributed as dist

    from .. import models
    from ..augment.mixup import mixup_targets, sample_mixup_lambdas
    from ..train.steps import _step_wav, global_norm, make_loss, shard_groups

    loss_fn = make_loss(loss_name, **(loss_args or {}))
    model = root.model
    group = root.data_group
    n_data = dist.get_world_size(group)
    tp_groups = shard_groups(model, optimizer.names)

    def step(batch, generator: Optional[torch.Generator] = None) -> dict:
        with sharded(rows):
            wav, target = _step_wav(batch["wav"], wav_augment), batch["target"]
            lamb = None
            if mixup_alpha:
                lamb = sample_mixup_lambdas(generator, wav.shape[0], mixup_alpha)
                target = mixup_targets(target, lamb)
            probs, new_state = root(models.forward, model_cfg, model, wav, train=True,
                                    generator=generator, mixup_lamb=lamb,
                                    wav_augment=wav_augment, spec_augment=spec_augment,
                                    frontend_fn=frontend_fn)
            loss = loss_fn(probs, target)
        loss.backward()
        grads = []
        with torch.no_grad():
            for p in optimizer.params:
                g = p.grad if p.grad is not None else torch.zeros_like(p)
                if not hasattr(g, "to_local"):  # whole over 'data': average it here
                    dist.all_reduce(g, group=group)
                    g /= n_data
                grads.append(g)
            gnorm = global_norm(grads, [((group,) if hasattr(g, "to_local") else ()) + m
                                        for g, m in zip(grads, tp_groups)])
            if max_grad_norm is not None:
                scale = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
                for g in grads:
                    _local(g).mul_(scale)
        models.load_state(model, new_state)
        # one foreach update over shards and whole (replicated) tensors
        from torch.distributed.tensor.experimental import implicit_replication

        with implicit_replication():
            optimizer.update(grads)
        return {"total_loss": loss.detach(), "grad_norm": gnorm}

    # eager by design: fully_shard gathers and frees the DTensor parameters
    # from host hooks and resizes their storage, which no CUDA graph holds
    step.graphs = None
    return step
