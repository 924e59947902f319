"""Tensor parallelism, counterpart of ``uit_mobile_tpu/parallel/tp.py``:
2-D (data x model) sharding of the UiT family in Megatron's pattern.

JAX places the weights by a PartitionSpec tree and GSPMD inserts the
collectives. The port has no GSPMD: each rank of a ``GridMesh`` holds only
its shard of every sharded weight, and a sharded ``Linear`` carries its
layout (``Linear.tp``, run by ``models.common.linear``):

- ``mlp.fc1``: column-parallel, kernel (None, model), bias (model,): this
  rank's hidden columns; the input's gradient summed over 'model';
- ``mlp.fc2``: row-parallel, kernel (model, None), bias (): one all-reduce
  over 'model' a block, the bias added once after it;
- ``head``: column-parallel, its class columns gathered over 'model';
- attention, with ``shard_attention`` only: qkv column-parallel, gathered
  before the q/k/v split (its 3*inner packed columns [q|k|v] cut mid-head:
  96 over 2 ranks split k in half, and 2 heads over 4 ranks cannot split
  by head at all), attention on every rank, proj row-parallel on this
  rank's columns of its input;
- everything else replicated.

The spec trees are JAX's key for key (keyed by parameter name, as
``fsdp_param_specs``), and a dim the axis does not divide stays whole
(``_fit_spec``): a 537-class head over 2 or 4 ranks is replicated.

The train step (``train.steps.make_train_step``) runs unchanged on the
sharded model: the ranks of one 'data' index hold the same rows (a
``parallel.rows.Rows`` over the 'data' group), the optimizer built on the
shards keeps its moments there (``sharded_opt_init``), and the pre-clip
gradient norm sums the shards' squares over 'model' (``model.shards``).
The MLP's dropout draws the whole hidden width and keeps this rank's
columns, so its draws are the single device's.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from .collectives import copy_to, gather_last, reduce_from, split_last
from .mesh import GridMesh, make_grid_mesh
from .rows import sharded


def make_mesh_2d(n_data: int, n_model: int, axes: tuple = ("data", "model"),
                 device="cuda") -> GridMesh:
    """The process group as an (n_data x n_model) mesh, 'model' innermost:
    the ranks of one model group are adjacent (one card each, NVLink), the
    'data' all-reduce rides the outer axis."""
    return make_grid_mesh({axes[0]: n_data, axes[1]: n_model}, device)


def _named(params):
    """(name, shape) pairs of a module's parameters or of a flat
    {name: array} dict."""
    if isinstance(params, nn.Module):
        return [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    return [(n, tuple(np.shape(v))) for n, v in params.items()]


def _spec_for(keys: tuple, ndim: int, model_axis: str, shard_attention: bool) -> tuple:
    def col():  # output-dim sharded
        return (None, model_axis) if ndim == 2 else (model_axis,)

    def row():  # input-dim sharded; the 1-D bias is added after the all-reduce
        return (model_axis, None) if ndim == 2 else ()

    if "mlp" in keys and "fc1" in keys:
        return col()
    if "mlp" in keys and "fc2" in keys:
        return row()
    if "head" in keys and "head_norm" not in keys:
        return col()
    if shard_attention and "attn" in keys and "qkv" in keys:
        return col()
    if shard_attention and "attn" in keys and "proj" in keys:
        return row()
    return ()


def tp_param_specs(params, *, model_axis: str = "model", shard_attention: bool = False) -> dict:
    """name -> spec (one entry a dim, the axis or None; () replicated) of a
    module's parameters or a flat {name: array} dict, by the rules above.
    Structural: ``_fit_spec`` fits them to a mesh."""
    return {name: _spec_for(tuple(name.split(".")), len(shape), model_axis, shard_attention)
            for name, shape in _named(params)}


def _fit_spec(spec: tuple, shape, mesh: GridMesh) -> tuple:
    """Drop a sharded dim the mesh axis does not divide evenly."""
    return tuple(None if a is not None and shape[i] % mesh.shape[a] else a
                 for i, a in enumerate(spec))


def place_params(mesh: GridMesh, model: nn.Module, specs: dict, axes=None):
    """Keep on this rank only its shard of each parameter, per ``specs``
    fitted to ``mesh`` (the dims of ``axes``, default every mesh axis), on
    the mesh's device; the buffers replicate. In place -> (model, fitted
    specs); a parameter already split over an axis keeps its shard. The
    model records them: ``model.shard_specs`` the fitted specs,
    ``model.shards`` per sharded parameter its (dim, axis, group) triples
    (its gradient's squares sum over those groups into the global norm)."""
    axes = tuple(mesh.shape) if axes is None else tuple(axes)
    fitted, shards = {}, dict(getattr(model, "shards", {}))
    for name, p in list(model.named_parameters()):
        spec = fitted[name] = _fit_spec(specs[name], p.shape, mesh)
        local, placed = p.detach(), {a for _, a, _ in shards.get(name, ())}
        for dim, axis in enumerate(spec):
            # an axis of one rank needs no collective; a placed one is kept
            if axis in axes and mesh.shape[axis] > 1 and axis not in placed:
                local = local.chunk(mesh.shape[axis], dim)[mesh.coords[axis]]
                shards[name] = shards.get(name, ()) + ((dim, axis, mesh.group(axis)),)
        if local.shape != p.shape:
            owner, _, leaf = name.rpartition(".")
            setattr(model.get_submodule(owner), leaf,
                    nn.Parameter(local.contiguous(), requires_grad=p.requires_grad))
    model.to(mesh.device)
    model.shards = shards
    model.shard_specs = {**getattr(model, "shard_specs", {}), **fitted}
    return model, fitted


class ColumnParallel:
    """A Linear holding this rank's output columns: x @ K_r + b_r, the
    input's gradient summed over the group; with ``gather`` every rank's
    columns concatenated (the consumer is replicated)."""

    def __init__(self, group, index: int, n: int, gather: bool):
        self.group, self.index, self.n, self.gather = group, index, n, gather

    def __call__(self, p, x):
        y = copy_to(x, self.group) @ p.kernel
        if p.bias is not None:
            y = y + p.bias
        return gather_last(y, self.group, self.index, self.n) if self.gather else y

    def out_columns(self, width: int):
        """(whole width, first column) of an ungathered output of ``width``
        columns, else None."""
        return None if self.gather else (width * self.n, self.index * width)


class RowParallel:
    """A Linear holding this rank's input rows: the group's sum of x_r @ K_r,
    then the whole bias; with ``split`` it first cuts this rank's columns
    from a replicated input."""

    def __init__(self, group, index: int, n: int, split: bool):
        self.group, self.index, self.n, self.split = group, index, n, split

    def __call__(self, p, x):
        if self.split:
            x = split_last(x, self.group, self.index, self.n)
        y = reduce_from(x @ p.kernel, self.group)
        return y + p.bias if p.bias is not None else y


def shard_params(mesh: GridMesh, model: nn.Module, *, model_axis: str = "model",
                 shard_attention: bool = False):
    """Shard ``model`` in place per ``tp_param_specs`` fitted to ``mesh``
    and give each sharded Linear its layout -> (model, fitted specs). Build
    the optimizer afterwards (``sharded_opt_init``)."""
    model, fitted = place_params(mesh, model, tp_param_specs(
        model, model_axis=model_axis, shard_attention=shard_attention), axes=(model_axis,))
    group, index, n = mesh.group(model_axis), mesh.coords[model_axis], mesh.shape[model_axis]

    def kind(name):
        dims = [d for d, _, _ in model.shards.get(f"{name}.kernel", ())]
        return "col" if dims == [1] else "row" if dims == [0] else None

    for name, mod in model.named_modules():
        k = kind(name)
        if k is None:
            continue
        # fc1's hidden columns feed fc2's rows straight when both are sharded
        if name.endswith("mlp.fc1"):
            pair = kind(name[:-1] + "2") == "row"
        elif name.endswith("mlp.fc2"):
            pair = kind(name[:-1] + "1") == "col"
        else:
            pair = False
        mod.tp = (ColumnParallel(group, index, n, gather=not pair) if k == "col"
                  else RowParallel(group, index, n, split=not pair))
    return model, fitted


def sharded_opt_init(optimizer, model: nn.Module):
    """``optimizer`` (an OptimizerSpec of train.steps) bound to a sharded
    model: its moments are allocated on the shards, so they are sharded
    like their weights -> (Optimizer, the moments' specs by parameter
    name). Adafactor is refused on shards: its factored moments and its
    update's RMS are the whole tensor's."""
    specs = dict(getattr(model, "shard_specs", {}))
    if optimizer.name == "Adafactor" and any(a is not None for s in specs.values() for a in s):
        raise ValueError("Adafactor's factored second moments and its update RMS are "
                         "per whole tensor; it does not run on shards")
    return optimizer.init(model), {n: specs.get(n, ()) for n, _ in model.named_parameters()}


def gather_params(model: nn.Module, tensors: Optional[dict] = None) -> dict:
    """name -> the whole parameter on the CPU, its shards over every axis
    gathered (TP's, EP's and FSDP's, with c10d's all_gather: gloo carries it
    for CUDA tensors); ``tensors`` (name -> a tensor placed like that
    parameter, an optimizer moment or a gradient) in place of the
    parameters. Every rank calls it."""
    import torch.distributed as dist

    out = {}
    for name, p in (tensors or dict(model.named_parameters())).items():
        t = p.detach()
        for dim, _, group in getattr(model, "shards", {}).get(name, ()):
            parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, t.contiguous(), group=group)
            t = torch.cat(parts, dim=dim)
        out[name] = t.to("cpu", copy=True)
    return out


def tensor_parallel_forward(apply_fn: Callable, mesh: GridMesh, model: nn.Module, *,
                            data_axis: str = "data", model_axis: str = "model",
                            shard_attention: bool = False) -> Callable:
    """An eval forward ``apply_fn(model, wav) -> probs`` over Megatron-sharded
    weights (``model`` is sharded in place) and batch-sharded rows ->
    ``fn(wav)``: every rank passes the global batch, runs its 'data' rows
    (the batch-global top_db clamp reduced over 'data') and returns the
    global probabilities. Give ``apply_fn`` the kernel frontend
    (``ops.mel.make_frontend_fn``): each rank launches it on its rows. On
    an NCCL mesh on the card, a CUDA graph per batch shape
    (``GridMesh.dispatch``: ``fn.eager``, ``fn.graphs``)."""
    model, _ = shard_params(mesh, model, model_axis=model_axis, shard_attention=shard_attention)

    def body(wav):
        local, rows = mesh.shard_rows(wav, data_axis)
        with sharded(rows):
            probs = apply_fn(model, local)
        return mesh.gather_rows(probs, data_axis)

    return mesh.dispatch(body)
