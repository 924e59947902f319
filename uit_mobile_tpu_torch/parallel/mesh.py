"""Device meshes and data-parallel placement, counterpart of
``uit_mobile_tpu/parallel/mesh.py``.

A ``Mesh`` is one 'data' axis over devices. In one process it is a list of
``torch.device``s, one per shard of the batch; a device may repeat (two
replicas on one card, or on the CPU, run as two shards). Across processes
(``multihost.initialize``) it is the process group: each rank holds one
shard on its own device. Weights replicate (``replicate_tree``), the batch
axis shards (``shard_batch``), and ``data_parallel_forward`` runs an eval
forward shard by shard.

A ``GridMesh`` is the process group as a grid of named axes, for the
model-parallel layouts (tp, sp, pp, ep, the hybrid FSDP x TP): each axis
has its own process group, and a forward takes the global batch on every
rank (``shard_rows``) and returns the global output (``gather_rows``). On
the card with every axis on NCCL each forward is a CUDA graph per key
(``GridMesh.dispatch``), as the JAX package jits each; on gloo it runs
eagerly.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from . import multihost
from .collectives import capturable, capture_agreement
from .rows import Rows, ThreadGroup, sharded


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: this process's shards' devices, in shard order.
    ``group``: the process group when the mesh spans processes (one shard
    a rank, None for the default group), else unset."""
    devices: tuple
    axis: str = "data"
    group: object = None
    spans_processes: bool = False

    @property
    def size(self) -> int:
        if not self.spans_processes:
            return len(self.devices)
        import torch.distributed as dist

        return dist.get_world_size(self.group)


@dataclasses.dataclass(frozen=True)
class Placement:
    """How a tree lies on a mesh (JAX's ``NamedSharding``): ``spec`` () is
    replicated, (axis,) sharded on the leading (batch) axis."""
    mesh: Mesh
    spec: tuple


@dataclasses.dataclass(frozen=True)
class GridMesh:
    """Every rank of the process group as a grid of named axes (JAX's
    multi-axis ``Mesh``), for the model-parallel layouts. Rank r sits at
    the row-major position r of ``shape`` (the last axis innermost, as
    JAX reshapes its device list). ``coords``: this rank's index on each
    axis; ``groups``: per axis, the process group of the ranks that differ
    from this one on that axis only; ``device``: this rank's device.
    ``shard_rows`` builds each share's ``Rows`` once (``rows``)."""
    shape: dict
    coords: dict
    groups: dict
    device: torch.device
    rows: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    @property
    def size(self) -> int:
        return int(np.prod(list(self.shape.values())))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph may hold this mesh's programs: on the card,
        with every axis's group on NCCL (``collectives.capturable``)."""
        return (torch.device(self.device).type == "cuda"
                and all(capturable(g) for g in self.groups.values()))

    def dispatch(self, body: Callable) -> Callable:
        """A forward ``fn(wav)`` of ``body(wav)``, which takes the global
        batch on this rank's device, under inference mode: one CUDA graph
        per key where the mesh is ``capturable`` (every rank captures a key
        at the same call, and a capture that fails on one raises on all),
        else ``body`` eagerly (``ops.graphs.graphed_forward``: ``fn.eager``,
        ``fn.graphs``)."""
        from ..ops.graphs import graphed_forward

        capture = self.capturable
        return graphed_forward(body, self.device, capture=capture,
                               agree=capture_agreement(self.device) if capture else None)

    def group(self, axis: str):
        return self.groups[axis]

    def rank_at(self, axis: str, index: int) -> int:
        """The global rank at this rank's position with ``axis`` set to ``index``."""
        coords = dict(self.coords, **{axis: index % self.shape[axis]})
        return int(np.ravel_multi_index([coords[a] for a in self.shape], list(self.shape.values())))

    def shard_rows(self, x, axis: Optional[str]):
        """This rank's rows of the global batch ``x`` over ``axis`` on its
        device, and the ``Rows`` of that share over the axis's group (the
        batch-global reductions of a forward or a step run over it); with
        no axis, or one of one rank, every row and no Rows."""
        x = torch.as_tensor(x)
        if axis is None or self.shape[axis] == 1:
            return x.to(self.device), None
        n = self.shape[axis]
        if x.shape[0] % n:
            raise ValueError(f"the '{axis}' axis ({n}) must divide the batch ({x.shape[0]})")
        local = x.chunk(n)[self.coords[axis]].to(self.device)
        # built once a share: Rows copies its row ids from the host, which
        # no capture may do
        key = (axis, local.shape[0])
        if key not in self.rows:
            self.rows[key] = Rows([local.shape[0]], self.device, group=self.groups[axis])
        return local, self.rows[key]

    def gather_rows(self, x: torch.Tensor, axis: Optional[str]) -> torch.Tensor:
        """Every rank's rows of ``x`` over ``axis``, concatenated in order (no
        gradient): a forward's output on every rank."""
        if axis is None or self.shape[axis] == 1:
            return x
        import torch.distributed as dist

        parts = [torch.empty_like(x) for _ in range(self.shape[axis])]
        dist.all_gather(parts, x.contiguous(), group=self.groups[axis])
        return torch.cat(parts)


def make_grid_mesh(shape: dict, device="cuda") -> GridMesh:
    """The process group as a ``GridMesh`` of ``shape`` (axis -> size, in
    order); every rank calls it (it creates each axis's groups).
    ``device``: this rank's device ('cuda' = the current card)."""
    import torch.distributed as dist

    from ..utils.device import resolve_device

    need = int(np.prod(list(shape.values())))
    if not multihost.is_initialized():
        raise ValueError(f"a mesh of {need} ranks spans a process group: call "
                         f"parallel.multihost.initialize first")
    world = dist.get_world_size()
    if world != need:
        raise ValueError(f"need {need} ranks for a {dict(shape)} mesh, have {world}")
    axes, sizes = list(shape), [int(n) for n in shape.values()]
    ranks = np.arange(need).reshape(sizes)
    me = dist.get_rank()
    coords = dict(zip(axes, (int(c) for c in np.unravel_index(me, sizes))))
    groups = {}
    for i, axis in enumerate(axes):  # every rank creates every group, in one order
        lines = np.moveaxis(ranks, i, -1).reshape(-1, sizes[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                groups[axis] = g
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return GridMesh(dict(zip(axes, sizes)), coords, groups, dev)


def _visible(device) -> list:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError("a CUDA mesh was requested but no CUDA GPU is available; "
                               "pass devices='cpu' (or a list of devices) to run on the CPU")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(n_devices: Optional[int] = None, axis: str = "data", devices="cuda") -> Mesh:
    """A mesh over ``devices``: 'cuda' (every visible card), 'cpu' (one
    CPU device), or a list of devices, which may repeat. ``n_devices``
    takes the first n."""
    devs = ([torch.device(d) for d in devices] if isinstance(devices, (list, tuple))
            else _visible(devices))
    if n_devices is not None:
        if len(devs) < n_devices:
            raise ValueError(f"need {n_devices} devices, have {len(devs)}")
        devs = devs[:n_devices]
    return Mesh(tuple(devs), axis)


def process_mesh(device, axis: str = "data", group=None) -> Mesh:
    """The mesh of every rank of the process group, this rank's shard on
    ``device``."""
    return Mesh((torch.device(device),), axis, group, spans_processes=True)


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def batch_sharded(mesh: Mesh, axis: str = "data") -> Placement:
    return Placement(mesh, (axis,))


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def shard_batch(mesh: Mesh, batch, axis: str = "data") -> list:
    """Host arrays or tensors, batch axis first -> one tree per shard of
    this process, each on its device. Across processes the rank's rows
    are its shard (``multihost.global_batch_from_host_local``)."""
    if mesh.spans_processes:
        return [multihost.global_batch_from_host_local(mesh, batch)]
    n = mesh.size

    def shard(x, i):
        x = torch.as_tensor(x)
        if x.shape[0] % n:
            raise ValueError(f"the '{axis}' mesh axis ({n}) must divide the batch "
                             f"({x.shape[0]})")
        return x.chunk(n)[i].to(mesh.devices[i])

    return [_map(lambda x, i=i: shard(x, i), batch) for i in range(n)]


def replicate_tree(mesh: Mesh, tree) -> list:
    """One copy of ``tree`` (modules or tensors, in dicts/lists) per shard
    of this process, on its device; a shard whose device already holds a
    module shares it (the weights are read only)."""
    def put(x, device):
        if isinstance(x, torch.nn.Module):
            here = next(x.parameters()).device
            return x if here == device else copy.deepcopy(x).to(device)
        return torch.as_tensor(x).to(device)

    return [_map(lambda x, d=d: put(x, d), tree) for d in mesh.devices]


def dp_placement(shard_dims: Sequence[int], axis: str = "data", devices=None, device=None):
    """Data-parallel mesh policy shared by the trainers (train, sed,
    pretrain). ``shard_dims`` are the batch-axis sizes the step shards
    (each PSL half independently).

    In a process group the mesh is every rank, and every dim must divide
    by their count: a rank that shrank its share would hang the others
    in the step's collectives. (Unlike JAX's, a group of one rank keeps its
    mesh: its collectives run, and its step is the single-process step
    bit for bit.) In one process: the largest number of ``devices`` (a
    list; default one) that divides every dim, and no mesh for one.

    Returns ``(mesh, batch_sharding, replicated_sharding)``, all None when
    one device is the right placement."""
    if multihost.is_initialized() or multihost.process_count() > 1:
        n_dev = multihost.process_count()
        bad = [d for d in shard_dims if d % n_dev]
        if bad:
            raise ValueError(
                f"multi-host training needs every batch axis {list(shard_dims)} "
                f"divisible by the global device count ({n_dev})")
        mesh = process_mesh(device or "cpu", axis)
        return mesh, batch_sharded(mesh, axis), replicated(mesh)
    devs = list(devices) if devices is not None else [device or "cpu"]
    n_dev = len(devs)
    while n_dev > 1 and any(d % n_dev for d in shard_dims):
        n_dev -= 1
    if n_dev <= 1:
        return None, None, None
    mesh = make_mesh(n_dev, axis, devices=devs)
    return mesh, batch_sharded(mesh, axis), replicated(mesh)


def data_parallel_forward(forward_fn, mesh: Optional[Mesh] = None,
                          axis: str = "data") -> Callable:
    """Wrap an eval forward (wav -> probs) for batch-sharded execution over
    an in-process mesh. ``forward_fn`` is one callable (every shard runs
    it: its weights' device serves every shard) or one per mesh device
    (``replicate_tree``'s replicas). The batch must divide by the mesh;
    callers pad (serve/, evaluate/). The shards' outputs are concatenated
    on the first device.

    Two routes, by what the forwards say of themselves (``ops.pipeline``'s
    ``fn.batch_global``):

    - no row of a forward's output depends on another row of its batch
      (``batch_global`` False: the per-sample clamp, no MoE routing): each
      replica calls its own forward, a CUDA-graph replay on the card, in
      turn from the calling thread (replays are asynchronous: no thread
      is needed);
    - otherwise (the batch-global ``top_db_mode='torch'`` clamp, the MoE's
      routing groups, a forward that says nothing) the shards run as the
      ranks of one collective, one thread each over a ``rows.ThreadGroup``,
      each its forward's eager version (``fn.eager``): their rendezvous is on
      the host, where no CUDA graph can hold it. So the clamp takes the max
      over every shard, on the kernel's route as on the plain frontend's.
      JAX runs a Pallas forward per shard under shard_map and so refuses
      that clamp there; the port has no such limit.

    ``fn.threaded`` says which route runs, ``fn.replicas`` are the
    forwards the replicas call."""
    mesh = mesh or make_mesh()
    if mesh.spans_processes:
        raise ValueError("data_parallel_forward runs an in-process mesh; a process group's "
                         "ranks each run their own forward")
    fns = list(forward_fn) if isinstance(forward_fn, (list, tuple)) else [forward_fn] * mesh.size
    if len(fns) != mesh.size:
        raise ValueError(f"{len(fns)} forwards for a mesh of {mesh.size} devices")
    n_axis = mesh.size
    threaded = n_axis > 1 and any(getattr(f, "batch_global", True) for f in fns)
    runs = [getattr(f, "eager", f) for f in fns] if threaded else fns

    def run_collective(shards):
        group = ThreadGroup(n_axis)
        outs: list = [None] * n_axis
        errors: list = []
        # each replica's thread enqueues on the caller's stream of its card
        streams = [torch.cuda.current_stream(d) if d.type == "cuda" else None
                   for d in mesh.devices]

        def replica(i):
            try:
                rows = Rows([shards[i].shape[0]], mesh.devices[i], group=group, rank=i)
                on_stream = (torch.cuda.stream(streams[i]) if streams[i] is not None
                             else contextlib.nullcontext())
                with sharded(rows), on_stream:
                    outs[i] = runs[i](shards[i])
            except BaseException as e:  # noqa: BLE001 - re-raised by the caller
                errors.append(e)
                group.abort()

        threads = [threading.Thread(target=replica, args=(i,), daemon=True)
                   for i in range(n_axis)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return outs

    def fn(wav):
        # only the sharded axis's size must divide the batch
        wav = torch.as_tensor(wav)
        if wav.shape[0] % n_axis:
            raise ValueError(f"the '{axis}' mesh axis ({n_axis}) must divide the batch "
                             f"({wav.shape[0]})")
        shards = [s.to(d) for s, d in zip(wav.chunk(n_axis), mesh.devices)]
        if n_axis == 1:
            return runs[0](shards[0])
        outs = (run_collective(shards) if threaded
                else [run(s) for run, s in zip(runs, shards)])
        return torch.cat([o.to(mesh.devices[0]) for o in outs])

    fn.uses_kernel = getattr(fns[0], "uses_kernel", False)
    fn.top_db_mode = getattr(fns[0], "top_db_mode", None)
    fn.threaded, fn.replicas = threaded, runs
    return fn
