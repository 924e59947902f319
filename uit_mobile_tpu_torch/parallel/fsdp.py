"""Fully-sharded data parallelism, counterpart of
``uit_mobile_tpu/parallel/fsdp.py``: parameters and optimizer moments
sharded over the same axis the batch is (ZeRO-3). Each rank stores 1/N of
every large tensor.

JAX places the weights by a sharding tree and jits the unchanged train
step with it; XLA inserts the all-gather of the weights and the
reduce-scatter of the gradients. The port does the same with a placement
and one step: the placement (``tp.place_params`` over the 'data' axis)
keeps each rank's shard as a plain parameter, recorded in
``model.shards``, and ``train.steps.make_train_step`` on a placed model
issues the two collectives itself (``DataShards``): one all-gather of
every shard before the forward, one reduce-scatter of their gradients
after the backward. Both run on the step's device side, so a CUDA graph
holds them on NCCL (``train.steps.dispatch_step``).

- ``fsdp_param_specs``: the largest dim of every tensor of at least
  ``min_size`` elements over the data axis (JAX's rule); smaller tensors
  replicated, their gradients averaged by the step's all-reduce.
- ``fsdp_shard_params``: fits those specs to the process mesh (a dim the
  axis does not divide stays replicated, as JAX's ``_fit_spec``) and
  places the model.
- ``hybrid_param_specs``, ``hybrid_shard_params``: the FSDP x TP
  composition on a ('data', 'model') ``GridMesh``: Megatron's pairing over
  'model' (parallel/tp.py), then the 'data' shard of each rank's TP
  shards. The step gathers over 'data' only: the Megatron layers consume
  the TP shards as they do under TP alone.

Build the optimizer on the placed model (``tp.sharded_opt_init``): its
moments then live on the shards. (The models import this package, so
this module imports nothing of them.)
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .mesh import GridMesh, Mesh
from .rows import sharded
from .tp import _fit_spec, _named, place_params, shard_params, tp_param_specs


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


def _data_grid(mesh: Mesh, axis: str, caller: str) -> GridMesh:
    """A process mesh as a one-axis ``GridMesh`` over its group."""
    if not mesh.spans_processes:
        raise ValueError(f"{caller} runs over a process group's mesh "
                         "(parallel.mesh.process_mesh)")
    return GridMesh({axis: mesh.size}, {axis: dist.get_rank(mesh.group)}, {axis: mesh.group},
                    mesh.devices[0])


def fsdp_shard_params(mesh: Mesh, model: nn.Module, *, axis: str = "data",
                      min_size: int = 1024):
    """Shard ``model`` in place over the process mesh ``mesh`` per
    ``fsdp_param_specs`` fitted to it -> (model, fitted specs), as JAX's
    (sharded params, sharding tree). Build the optimizer on the model
    afterwards (``tp.sharded_opt_init``)."""
    grid = _data_grid(mesh, axis, "fsdp_shard_params")
    specs = fsdp_param_specs(model, axis=axis, min_size=min_size)
    model, fitted = place_params(grid, model, specs)
    model.fsdp_axis = axis
    return model, fitted


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
    (``tp.shard_params``), then its 'data' shard of each -> (model, fitted
    specs). Build the optimizer on the model afterwards."""
    specs = hybrid_param_specs(model, data_axis=data_axis, model_axis=model_axis,
                               min_size=min_size, shard_attention=shard_attention)
    fitted = {k: _fit_spec(specs[k], shape, mesh) for k, shape in _named(model)}
    shard_params(mesh, model, model_axis=model_axis, shard_attention=shard_attention)
    # the 'data' dims are free of 'model', so the TP shards keep their whole size there
    place_params(mesh, model, fitted, axes=(data_axis,))
    model.shard_specs, model.fsdp_axis = fitted, data_axis
    return model, fitted


class _Call(nn.Module):
    """``forward(fn, *args, **kwargs)`` = ``fn(*args, **kwargs)``: the module
    ``functional_call`` swaps the gathered tensors into (the port's
    forwards are functions of the model, not its ``forward``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, fn: Callable, *args, **kwargs):
        return fn(*args, **kwargs)


def _host_staged(group, t: torch.Tensor) -> bool:
    """gloo moves a CUDA tensor through the host (collectives.exchange)."""
    return t.device.type != "cpu" and dist.get_backend(group) == "gloo"


class DataShards:
    """The parameters an FSDP placement split over its 'data' axis, and the
    step's two collectives over that axis's group, each one coalesced
    collective on a flat buffer the step allocates:

    - ``gather(params)``: one ``all_gather_into_tensor`` of every shard,
      each whole tensor rebuilt from the n pieces along its sharded dim
      (the largest, often not dim 0) as a fresh leaf, which requires grad
      where its shard does and grad mode is on (not in an eval forward);
    - ``call(whole, fn, ...)``: ``fn`` with the model reading those
      tensors in place of its shards (``torch.func.functional_call``;
      ``model.reads_whole`` is true meanwhile);
    - ``reduce_scatter(grads)``: their gradients packed rank-major (for
      rank r every tensor's r-th chunk), one ``reduce_scatter_tensor``, divided
      by n: under ``rows`` each rank differentiates the rank-identical
      global loss, so the sum is n x the gradient.

    ``index``: the positions of the sharded parameters in the optimizer's
    list. Between steps the model holds the shards alone."""

    def __init__(self, model: nn.Module, names: list, axis: str):
        shards = getattr(model, "shards", {})
        self.index, self.dims, self.group = [], [], None
        for i, name in enumerate(names):
            for dim, a, group in shards.get(name, ()):
                if a == axis:
                    self.index.append(i)
                    self.dims.append(dim)
                    self.group = group
        self.names = [names[i] for i in self.index]
        params = dict(model.named_parameters())
        self.shapes = [params[n].shape for n in self.names]  # the shards'
        self.n = dist.get_world_size(self.group)
        self._call = _Call(model)

    def gather(self, params: list) -> list:
        grad = [params[i].requires_grad for i in self.index]
        local = [params[i].detach() for i in self.index]
        if len({t.dtype for t in local}) > 1:
            raise ValueError("FSDP gathers its shards in one buffer: one dtype")
        flat = torch.cat([t.reshape(-1) for t in local])
        wire = flat.cpu() if _host_staged(self.group, flat) else flat
        out = wire.new_empty(self.n * wire.numel())
        dist.all_gather_into_tensor(out, wire, group=self.group)
        pieces = out.to(flat.device).view(self.n, -1).split([t.numel() for t in local], dim=1)
        whole = []
        for t, dim, piece, g in zip(local, self.dims, pieces, grad):
            # (n, *shard) -> the n shards concatenated on dim
            shape = list(t.shape)
            shape[dim] *= self.n
            whole.append(piece.reshape(self.n, *t.shape).movedim(0, dim).reshape(shape)
                         .requires_grad_(g and torch.is_grad_enabled()))
        return whole

    def call(self, whole: list, fn: Callable, *args, **kwargs):
        model = self._call.model
        model.reads_whole = True
        try:
            return torch.func.functional_call(
                self._call, {f"model.{n}": t for n, t in zip(self.names, whole)},
                (fn, *args), kwargs)
        finally:
            model.reads_whole = False

    def reduce_scatter(self, grads: list) -> list:
        packed = torch.cat([g.unflatten(dim, (self.n, -1)).movedim(dim, 0).reshape(self.n, -1)
                            for g, dim in zip(grads, self.dims)], dim=1).reshape(-1)
        wire = packed.cpu() if _host_staged(self.group, packed) else packed
        out = wire.new_empty(wire.numel() // self.n)
        dist.reduce_scatter_tensor(out, wire, group=self.group)
        out = out.to(packed.device) / self.n
        return [v.view(s) for v, s in zip(out.split([s.numel() for s in self.shapes]),
                                           self.shapes)]


def data_shards(model: nn.Module, names: list) -> Optional[DataShards]:
    """The ``DataShards`` of a model placed by ``fsdp_shard_params`` or
    ``hybrid_shard_params`` (``names``: the optimizer's parameter names),
    or None where no parameter is sharded over its 'data' axis (another
    placement, or an axis of one rank)."""
    axis = getattr(model, "fsdp_axis", None)
    if axis is None or not any(a == axis for entries in getattr(model, "shards", {}).values()
                               for _, a, _ in entries):
        return None
    return DataShards(model, names, axis)


def fsdp_forward(apply_fn: Callable, mesh, model: nn.Module) -> Callable:
    """An eval forward ``apply_fn(model, wav) -> probs`` over a model placed
    by ``fsdp_shard_params`` (``mesh``: that process mesh) or
    ``hybrid_shard_params`` (``mesh``: that ``GridMesh``) -> ``fn(wav)``:
    every rank passes the global batch, runs its rows of the placement's
    'data' axis (the batch-global top_db clamp reduced over it) with the
    model reading the whole tensors of one all-gather of its 'data' shards
    (``DataShards``; the hybrid's Megatron layers keep their TP shards), and
    returns the global probabilities. Give ``apply_fn`` the kernel frontend
    (``ops.mel.make_frontend_fn``): each rank launches it on its rows. On
    an NCCL mesh on the card, a CUDA graph per batch shape, the all-gather
    in it (``GridMesh.dispatch``: ``fn.eager``, ``fn.graphs``). JAX jits
    the unchanged forward under the placement's shardings."""
    axis = getattr(model, "fsdp_axis", None)
    if axis is None:
        raise ValueError("fsdp_forward runs a placed model: place it with fsdp_shard_params "
                         "or hybrid_shard_params first")
    grid = mesh if isinstance(mesh, GridMesh) else _data_grid(mesh, axis, "fsdp_forward")
    shards = data_shards(model, [n for n, _ in model.named_parameters()])

    def body(wav):
        local, rows = grid.shard_rows(wav, axis)
        with sharded(rows):
            if shards is None:  # an axis of one rank: nothing is split
                probs = apply_fn(model, local)
            else:
                whole = shards.gather([p for _, p in model.named_parameters()])
                probs = shards.call(whole, apply_fn, model, local)
        return grid.gather_rows(probs, axis)

    return grid.dispatch(body)
