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

The FSDP x TP composition (``hybrid_param_specs``, ``hybrid_shard_params``)
raises until tensor parallelism exists (ROADMAP §A17b).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .. import models
from ..augment.mixup import mixup_targets, sample_mixup_lambdas
from .mesh import Mesh
from .rows import Rows, sharded


def _named(params):
    """(name, shape) pairs of a module's parameters or of a flat
    {name: array} dict."""
    if isinstance(params, nn.Module):
        return [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    return [(n, tuple(np.shape(v))) for n, v in params.items()]


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
    reduce-scatters their gradients."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)


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
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    n = mesh.size
    shapes = dict(_named(model))
    fitted = {k: _fit(s, shapes[k], n) for k, s in fsdp_param_specs(
        model, axis=axis, min_size=min_size).items()}
    dims = {id(p): fitted[k].index(axis) for k, p in model.named_parameters()
            if axis in fitted[k]}
    replicated = {p for k, p in model.named_parameters() if axis not in fitted[k]}
    root = FSDPRoot(model)
    device_mesh = init_device_mesh(mesh.devices[0].type, (n,), mesh_dim_names=(axis,))
    fully_shard(root, mesh=device_mesh, shard_placement_fn=lambda p: Shard(dims[id(p)]),
                ignored_params=replicated)
    return root, fitted


def hybrid_param_specs(*args, **kwargs):
    """FSDP x TP (JAX's ``hybrid_param_specs``) needs tensor parallelism."""
    raise NotImplementedError("hybrid FSDP x TP placement waits for tensor parallelism "
                              "(ROADMAP §A17b)")


def hybrid_shard_params(*args, **kwargs):
    """FSDP x TP (JAX's ``hybrid_shard_params``) needs tensor parallelism."""
    raise NotImplementedError("hybrid FSDP x TP placement waits for tensor parallelism "
                              "(ROADMAP §A17b)")


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
    model sharded by ``fsdp_shard_params``: ``step(batch, generator) ->
    {'total_loss', 'grad_norm'}``. ``optimizer`` is the port's Optimizer
    built on ``root.model`` after sharding. The sharded gradients arrive
    averaged over the ranks by FSDP's reduce-scatter, the replicated ones
    by an all-reduce; the pre-clip norm and the clip are the global
    gradient's."""
    import torch.distributed as dist

    from ..train.steps import _step_wav, make_loss

    loss_fn = make_loss(loss_name, **(loss_args or {}))
    model = root.model
    world = dist.get_world_size()

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
                if not hasattr(g, "to_local"):  # a replicated tensor: average it here
                    dist.all_reduce(g)
                    g /= world
                grads.append(g)
            # the global norm: the shards' squares summed over the ranks
            sq_sharded = sum((_local(g).double() ** 2).sum() for g in grads
                             if hasattr(g, "to_local"))
            sq_sharded = torch.as_tensor(sq_sharded, dtype=torch.float64,
                                         device=_local(grads[0]).device)
            dist.all_reduce(sq_sharded)
            sq = sq_sharded + sum((g.double() ** 2).sum() for g in grads
                                  if not hasattr(g, "to_local"))
            gnorm = torch.sqrt(sq).float()
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

    return step
