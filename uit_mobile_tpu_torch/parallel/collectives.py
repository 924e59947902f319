"""The collectives of the model-parallel layouts (``tp``, ``sp``, ``pp``,
``ep``), with the gradients Megatron's layers need.

Under GSPMD, JAX differentiates through the collectives it inserts. Here
each is an autograd function whose backward is the one its layout needs:

- ``copy_to`` (Megatron's f): identity forward; the backward sums the
  gradient over the group. It marks a replicated tensor read by a sharded
  computation: each rank's consumer sees part of it.
- ``reduce_from`` (Megatron's g): the sum over the group forward; identity
  backward. The consumer is replicated over the group, so each rank's
  gradient is already the whole one. (``torch.distributed.nn``'s
  all-reduce sums the gradient again, which would multiply it by the
  group's size here.)
- ``gather_last`` / ``split_last``: every rank's piece of the last axis
  concatenated, or this rank's piece cut from a replicated tensor; each
  backward is the other's forward on a replicated gradient.

``exchange`` posts point-to-point sends and receives together
(``batch_isend_irecv``: NCCL on the card). gloo moves only CPU tensors
point to point, so on gloo a CUDA tensor goes through the host.

``capturable`` is the one rule of which groups a CUDA graph may hold: a
program whose collectives all run on NCCL is captured (``ops/graphs.py``),
any other runs eagerly. ``capture_agreement`` makes a capture that fails on
one rank raise on every rank.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from .rows import ThreadGroup


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def _all_gather_last(x, group, n):
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim=-1)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.index, ctx.width = index, x.shape[-1]
        return _all_gather_last(x, group, n)

    @staticmethod
    def backward(ctx, g):
        return g[..., ctx.index * ctx.width:(ctx.index + 1) * ctx.width], None, None, None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, index, n):
        ctx.group, ctx.n = group, n
        w = x.shape[-1] // n
        return x[..., index * w:(index + 1) * w]

    @staticmethod
    def backward(ctx, g):
        return _all_gather_last(g, ctx.group, ctx.n), None, None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _Copy.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _Reduce.apply(x, group)


def gather_last(x: torch.Tensor, group, index: int, n: int) -> torch.Tensor:
    return _Gather.apply(x, group, index, n)


def split_last(x: torch.Tensor, group, index: int, n: int) -> torch.Tensor:
    return _Split.apply(x, group, index, n)


def exchange(sends: list, recvs: list, group) -> list:
    """Send each ``(tensor, peer)`` of ``sends`` and receive one tensor like
    ``like`` from ``peer`` for each ``(like, peer)`` of ``recvs`` (peers are
    global ranks of ``group``), all posted at once -> the received tensors,
    on their ``like``'s device. The i-th send to a peer meets that peer's
    i-th receive from this rank (tags by position). No gradient."""
    if not sends and not recvs:
        return []
    host = dist.get_backend(group) == "gloo"

    def wire(t):
        t = t.detach().contiguous()
        return t.cpu() if host else t

    bufs = [torch.empty(like.shape, dtype=like.dtype,
                        device="cpu" if host else like.device) for like, _ in recvs]
    ops = [dist.P2POp(dist.isend, wire(t), peer, group, tag=i)
           for i, (t, peer) in enumerate(sends)]
    ops += [dist.P2POp(dist.irecv, buf, peer, group, tag=i)
            for i, (buf, (_, peer)) in enumerate(zip(bufs, recvs))]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return [buf.to(like.device) for buf, (like, _) in zip(bufs, recvs)]


def capturable(group) -> bool:
    """Whether a CUDA graph may hold the collectives of ``group`` (a process
    group, None for the default one, or a ``rows.ThreadGroup``): NCCL's
    run on the card, and a capture records them; gloo moves a CUDA tensor
    through the host (``exchange``, and gloo's own collectives copy), and a
    ThreadGroup meets on the host."""
    if isinstance(group, ThreadGroup):
        return False
    return dist.get_backend(group) == "nccl"


def capture_agreement(device) -> Callable[[bool], bool]:
    """-> ``agree(ok) -> bool``: whether every rank of the world captured
    its graph, each rank passing whether its own capture did; one MIN
    all-reduce of a flag on ``device`` (the card, for NCCL) over the
    default group, run eagerly between a capture and its first replay. It
    spans the whole world because every rank captures a key at the same
    call (their batches have one shape: ``Rows.check_local``), so they
    meet here together, and a capture that failed on one rank raises on
    every rank instead of leaving the others waiting in the graph's
    collectives."""
    def agree(ok: bool) -> bool:
        flag = torch.tensor([int(ok)], dtype=torch.int32, device=device)
        dist.all_reduce(flag, op=dist.ReduceOp.MIN)
        return bool(flag.item())

    return agree
