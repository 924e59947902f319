"""One rank's rows of a global batch, and the operations that mix rows.

Under GSPMD the JAX data-parallel step *is* the single-device step on the
global batch (``tests/test_parallel.py:46-84``). The port runs one process
per rank, and a step that runs under ``sharded(rows)`` makes every
operation that mixes rows global, so that N ranks compute what one process
computes on the global batch:

- per-row random draws (mixup lambdas, wave augments, spectrogram masks,
  dropout, drop-path, MAE's noise) draw the global batch's shape from the
  generator, which every rank seeds alike, and keep this rank's rows
  (``rand_rows``, ``Rows.take``);
- batch statistics (BatchNorm) and the top_db clamp's max reduce over the
  group (``Rows.all_reduce``, with autograd where gradients flow);
- mixup's ``flip`` pairs global row i with row B-1-i, which lives on
  another rank (``Rows.flip``);
- the loss reduces over the global batch and the gradients are summed over
  the group (``train/steps.py``).

Outside ``sharded`` (``current()`` is None) every site runs its
single-device code: the single-process path gains no collective and no
launch. Inside it, with a group of one rank, every operation gives the
single-process bits (the collectives of one rank copy).

The replicas of an in-process mesh (``parallel/mesh.py``) run the same
sites on threads over a ``ThreadGroup``; there only the reductions of an
eval forward (the top_db clamp) meet.
"""

from __future__ import annotations

import contextlib
import contextvars
import threading
from typing import Optional, Sequence

import numpy as np
import torch

_CURRENT: contextvars.ContextVar = contextvars.ContextVar("uit_rows", default=None)


def current() -> Optional["Rows"]:
    """The rows of the step running on this thread, or None."""
    return _CURRENT.get()


@contextlib.contextmanager
def sharded(rows: Optional["Rows"]):
    """Run the block with ``rows`` as this thread's share of the global
    batch (None: the single-device code)."""
    token = _CURRENT.set(rows)
    try:
        yield rows
    finally:
        _CURRENT.reset(token)


class ThreadGroup:
    """The replicas of an in-process mesh as the ranks of one collective:
    each replica's forward runs on its own thread and meets the others in
    ``all_reduce``. A replica that fails breaks the barrier, so the others
    raise instead of waiting; a missing one raises after ``timeout`` s."""

    def __init__(self, size: int, timeout: float = 120.0):
        self.size = size
        self._barrier = threading.Barrier(size, timeout=timeout)
        self._slots: list = [None] * size

    def all_reduce(self, rank: int, t: torch.Tensor, op: str) -> torch.Tensor:
        self._slots[rank] = t
        self._barrier.wait()
        parts = torch.stack([s.to(t.device) for s in self._slots])
        out = parts.sum(0) if op == "sum" else parts.amax(0)
        self._barrier.wait()  # nobody overwrites a slot before all have read
        return out

    def abort(self) -> None:
        self._barrier.abort()


class Rows:
    """This rank's rows of a global batch made of consecutive blocks, each
    split evenly over the ranks in rank order: ``blocks`` are this rank's
    row counts per block. One block is a flat batch; PSL's two blocks are
    JAX's ``[all audioset, all kws]`` order (each rank holds its audioset
    rows, then its kws rows). ``group`` is a ``torch.distributed`` process
    group (None: the default one) or a ``ThreadGroup``."""

    def __init__(self, blocks: Sequence[int], device, group=None, rank: Optional[int] = None,
                 world: Optional[int] = None):
        if isinstance(group, ThreadGroup):
            if rank is None:
                raise ValueError("a ThreadGroup's Rows need their rank")
            world = group.size
        else:
            import torch.distributed as dist

            rank = dist.get_rank(group) if rank is None else rank
            world = dist.get_world_size(group) if world is None else world
        self.group, self.rank, self.world = group, rank, world
        self.device = torch.device(device)
        blocks = [int(n) for n in blocks]
        starts = np.cumsum([0] + [n * world for n in blocks])[:-1]
        ids = np.stack([np.concatenate([s + r * n + np.arange(n) for s, n in zip(starts, blocks)])
                        for r in range(world)])  # (world, rows): every rank's global row ids
        self.total = int(ids.size)
        self.local = int(ids.shape[1])
        self.index = torch.as_tensor(ids[rank], device=self.device)
        where = np.empty(self.total, dtype=np.int64)
        where[ids.reshape(-1)] = np.arange(self.total)
        # positions, in the rank-major gather of every rank's rows, of the
        # global rows B-1-i for this rank's rows i
        self._mirror = torch.as_tensor(where[self.total - 1 - ids[rank]], device=self.device)

    def take(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of a tensor drawn at the global batch's size."""
        if x.shape[axis] != self.total:
            raise ValueError(f"expected {self.total} global rows on axis {axis}, "
                             f"got {tuple(x.shape)}")
        return x.index_select(axis, self.index.to(x.device))

    def check_local(self, n: int, what: str) -> None:
        if n != self.local:
            raise ValueError(f"{what}: {n} rows on this rank, but its share of the global "
                             f"batch is {self.local}")

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """The sum or max of ``t`` over the group; gradients flow through a
        sum (its backward sums the gradients over the group)."""
        if isinstance(self.group, ThreadGroup):
            return self.group.all_reduce(self.rank, t, op)
        import torch.distributed as dist
        import torch.distributed.nn.functional as dist_fn

        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if op == "sum":
            # c10d's autograd all-reduce (deprecated for the functional
            # collectives, which crashed on gloo with CUDA tensors on the H100)
            return dist_fn.all_reduce(t, op=red, group=self.group)
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=red, group=self.group)
        return out

    def mean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean over the group of per-rank means of equal counts."""
        return self.all_reduce(t) / self.world

    def flip(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This rank's rows of the global batch flipped on ``axis``: global
        row i takes row B-1-i, which lives on another rank (no exchange
        with one rank)."""
        axis = axis % x.dim()
        self.check_local(x.shape[axis], "flip")
        if self.world == 1:  # flip keeps the layout, and so the sums after it
            return x.flip(axis)
        import torch.distributed.nn.functional as dist_fn

        parts = dist_fn.all_gather(x.contiguous(), group=self.group)
        return torch.cat(parts, dim=axis).index_select(axis, self._mirror.to(x.device))


def rand_rows(generator, shape, device) -> torch.Tensor:
    """``torch.rand(shape)`` whose axis 0 is the batch: under ``sharded``,
    this rank's rows of the draw at the global batch's size."""
    rows = current()
    if rows is None:
        return torch.rand(shape, generator=generator, device=device)
    rows.check_local(shape[0], "a per-row draw")
    return rows.take(torch.rand((rows.total, *shape[1:]), generator=generator, device=device))


def global_max(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a max over this rank's rows) as the max over the global batch."""
    rows = current()
    return t if rows is None else rows.all_reduce(t, "max")


def global_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` (a sum over this rank's rows) as the sum over the global batch;
    gradients flow."""
    rows = current()
    return t if rows is None else rows.all_reduce(t)
