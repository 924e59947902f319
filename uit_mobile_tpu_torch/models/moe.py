"""Mixture-of-Experts UiT variant, counterpart of ``uit_mobile_tpu/models/moe.py``.

Each block's MLP becomes a routed expert bank (GShard/Switch-style top-k
token routing with a fixed per-expert capacity). Everything outside the
MLP (frontend, patch embed, pos embeds, attention with the full-dim-scale
quirk, pooling, head) is the UiT code itself (models/uit.py, through
``block_forward``'s ``mlp_fn`` hook).

Parameters mirror the JAX pytree key for key: a block holds
``moe.router.kernel`` (D, E), ``moe.fc1.kernel`` (E, D, H),
``moe.fc1.bias`` (E, H), ``moe.fc2.kernel`` (E, H, D) and ``moe.fc2.bias``
(E, D) in place of ``mlp``, so ``ckpt/convert.py`` carries them as they are.

Routing places each token the way the JAX package's dense one-hot
formulation does (G groups of S tokens, E experts, C slots an expert a
group; slots filled round by round, top-1 choices first, and in token order
within a round; a choice past C dropped), but moves tokens through integer
slot maps in place of the (G, S, E, C) dispatch and combine tensors:
``slot_of`` (each token's choice -> its slot in the (E, G, C) bank) and
``choice_of`` (each slot -> the token's choice filling it). Dispatch
gathers the tokens' rows into the bank and combine gathers each token's k
expert outputs back, each an autograd function whose backward is a gather
through the other map (no atomics, so a step repeats bitwise). The expert
computation is one batched (E, G*C, D) x (E, D, H) product, empty slots
zero rows, as the dense form has it. Two points where PyTorch differs from
JAX are handled here:

- ``_top_k`` breaks ties toward the lower expert index, as
  ``jax.lax.top_k`` does (a stable descending sort; ``torch.topk`` on CUDA
  promises no order among equal values);
- the router softmax, top-k and the combine weights stay float32 under
  ``compute_dtype='bfloat16'`` until combine, which casts the weights to
  the compute dtype as the dense form's ``combine`` is cast; the expert
  products run in the compute dtype.

Memory: a block keeps for its backward the expert bank's inputs and
outputs, O(E*G*C*D) (C is about k*S/E times the capacity factor, so a few
times the tokens' own rows), and the maps, O(k*G*S) integers. No tensor
of G*S*E*C elements is made, forward or backward: at B=32 clips of 10 s
and full width one would be 252 MB a block in float32.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import copy_to, reduce_from
from ..parallel.rows import current as current_rows
from ..utils.profiling import span, spanning
from . import uit
from .common import ACTIVATIONS, batch_norm_train, layer_norm, trunc_normal


@dataclasses.dataclass(frozen=True)
class MoEUITConfig:
    """UiT geometry (``base``) + routing hyperparameters."""

    base: uit.UITConfig
    n_experts: int = 8
    top_k: int = 2
    # per-expert slot budget C = ceil(top_k * group_tokens / n_experts *
    # factor); tokens routed past an expert's budget are dropped (their
    # residual passes through unchanged)
    capacity_factor: float = 2.0
    # Switch-style load-balancing auxiliary loss weight
    router_aux_weight: float = 1e-2
    # tokens per routing group; None = auto: groups of gcd(B, 8) clips.
    # Must divide the total token count when set.
    group_size: Optional[int] = None

    def __post_init__(self):
        if not (self.n_experts >= 1 and 1 <= self.top_k <= self.n_experts):
            raise ValueError(f"need n_experts >= 1 and 1 <= top_k <= n_experts, got "
                             f"{self.n_experts}, {self.top_k}")
        if self.base.pooling != "mean":
            raise ValueError("MoE factories ship 'mean' pooling")

    # the registry-facing fields of UITConfig, read by the harness paths
    @property
    def outputdim(self) -> int:
        return self.base.outputdim

    @property
    def frontend(self):
        return self.base.frontend

    @property
    def target_length(self) -> int:
        return self.base.target_length

    @property
    def mel_layout(self) -> str:
        return self.base.mel_layout

    @property
    def compute_dtype(self) -> str:
        return self.base.compute_dtype


# ------------------------------------------------------------------- modules

class Router(nn.Module):
    def __init__(self, d: int, e: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d, e))


class ExpertLinear(nn.Module):
    """E stacked Linears: kernel (E, in, out), bias (E, out)."""

    def __init__(self, e: int, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(e, d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(e, d_out))


class MoE(nn.Module):
    """``ep``: under expert parallelism (parallel/ep.py) this rank's share of
    the banks (``first`` expert, the 'expert' ``group``); None when whole."""

    ep = None

    def __init__(self, cfg: MoEUITConfig):
        super().__init__()
        D = cfg.base.embed_dim
        H = int(D * cfg.base.mlp_ratio)
        E = cfg.n_experts
        self.router = Router(D, E)
        self.fc1 = ExpertLinear(E, D, H)
        self.fc2 = ExpertLinear(E, H, D)


class MoEUiT(uit.UiT):
    """The UiT parameter container with every block's ``mlp`` replaced by
    ``moe``."""

    def __init__(self, cfg: MoEUITConfig):
        super().__init__(cfg.base)
        self.cfg = cfg
        for blk in self.blocks:
            del blk.mlp
            blk.moe = MoE(cfg)


@torch.no_grad()
def init(cfg: MoEUITConfig, generator: torch.Generator) -> MoEUiT:
    """A CPU MoEUiT: ``uit.init``'s trunk, then per block a router drawn
    0.02 * N(0, 1) and every expert initialized like the dense MLP
    (trunc_normal(0.02) kernels, zero biases), from ``generator``."""
    dense = uit.init(cfg.base, generator)
    model = MoEUiT(cfg)
    trunk = {k: v for k, v in dense.state_dict().items() if ".mlp." not in k}
    missing, unexpected = model.load_state_dict(trunk, strict=False)
    if unexpected or any(".moe." not in k for k in missing):
        raise RuntimeError(f"MoE trunk mismatch: missing {missing}, unexpected {unexpected}")
    E = cfg.n_experts
    for blk in model.blocks:
        m = blk.moe
        for lin in (m.fc1, m.fc2):
            _, d_in, d_out = lin.kernel.shape
            lin.kernel.copy_(torch.stack([trunc_normal(generator, (d_in, d_out))
                                          for _ in range(E)]))
            lin.bias.zero_()
        m.router.kernel.copy_(0.02 * torch.randn(m.router.kernel.shape, generator=generator))
    return model


# ------------------------------------------------------------------- routing

def _group_size(cfg: MoEUITConfig, B: int, N: int) -> int:
    """Tokens per routing group. Auto: groups of gcd(B, 8) clips."""
    T = B * N
    if cfg.group_size is not None:
        if T % cfg.group_size:
            raise ValueError(f"group_size {cfg.group_size} must divide {T} tokens")
        return cfg.group_size
    return N * math.gcd(B, 8)


def _top_k(gates: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index (jax.lax.top_k's order)."""
    values, indices = torch.sort(gates, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def moe_mlp(cfg: MoEUITConfig, p: MoE, x: torch.Tensor):
    """Routed MLP: (B, N, D) -> ((B, N, D), aux_loss).

    Tokens split into G groups of S; per group, top-k softmax routing with
    combine weights renormalized over the selected experts and a fixed
    per-expert capacity C:

        expert_in[e, (g, c)] = x[token in slot c of expert e, group g]  (E, G*C, D)
        expert_out           = fc2(act(fc1(expert_in)))
        y[t]                 = sum_j w[t, j] * expert_out[slot of t's j-th choice]

    aux = E * sum_e f_e * P_e (Switch load balancing: f = fraction of tokens
    whose top-1 choice is e, P = mean router probability of e).

    Under ``parallel.rows.sharded`` the batch is this rank's consecutive
    rows of a global batch (a flat batch, ranks in order), and the groups
    are the global batch's, so a group may span ranks: every rank's routing
    choices are summed into place over the data group (an all-gather that
    ``Rows``' in-process groups carry too), each token's slot counts the
    group's tokens before it, and this rank fills its own tokens' slots
    (the others' stay empty); f and P are the global batch's. With ``p.ep``
    this rank holds experts [first, first + its banks) only and runs them,
    and one all-reduce over the 'expert' group sums the combine.

    Its spans (``utils/profiling.py:span``): ``uit.moe.mlp`` around the
    forward, holding ``uit.moe.route`` (router, softmax, top-k, the slot
    maps), ``uit.moe.dispatch`` (the gather of ``expert_in``),
    ``uit.moe.experts`` (fc1, activation, fc2) and ``uit.moe.combine`` (the
    gather and weighted sum of ``y``); and ``uit.moe.mlp.backward``,
    opened by a grad hook on the outputs and closed by one on ``x``,
    registered only while a span records anything (the block's ``x`` feeds
    this MLP alone, so the backward between the two is the MLP's)."""
    with span("moe.mlp"):
        y, aux = _moe_mlp(cfg, p, x)
    if spanning() and torch.is_grad_enabled() and x.requires_grad:
        backward, opened = span("moe.mlp.backward"), []

        def open_(grad):  # the first of the outputs' gradients to arrive
            if not opened:
                opened.append(backward.open())

        def close(grad):
            if opened:
                opened.clear()
                backward.close()

        for out in (y, aux):
            if out.requires_grad:
                out.register_hook(open_)
        x.register_hook(close)
    return y, aux


class _Routes(NamedTuple):
    """One block's routing (``_route``): the rows of the groups holding this
    rank's tokens (``xt`` (G*S, D), their combine weights ``w`` (G*S, k),
    another rank's tokens zero rows and zero weights), the slot maps over
    them (``_slot_maps``), ``row0``: this rank's first row in them, and the
    load-balancing loss ``aux``."""

    xt: torch.Tensor
    w: torch.Tensor
    slot_of: torch.Tensor
    choice_of: torch.Tensor
    row0: int
    aux: torch.Tensor


def _slot_maps(topi: torch.Tensor, live: torch.Tensor, n_experts: int, capacity: int,
               first: int, n_local: int):
    """(G, S, k) choices -> (slot_of, choice_of), int32.

    A choice's slot in its expert is the number of that expert's choices
    before it, round by round (every token's j-th choice before any (j+1)-th)
    and in token order within a round: the dense form's per-round cumsum
    plus the slots earlier rounds took, here one cumsum over the (j, s)
    order. It is placed iff its slot is under ``capacity``, it is ``live``
    (weight > 0: the dense form's ``dispatch = combine > 0``) and its
    expert is one of [first, first + n_local). ``slot_of`` (G*S, k): the
    flat index into the (n_local, G, capacity) bank, or the bank's size
    where not placed. ``choice_of`` (bank): the flat choice t*k + j filling
    each slot (``// k``: its token), or G*S*k where empty. A slot takes at
    most one choice, so one scatter with unique indices writes
    ``choice_of``: each unplaced choice to a place of its own past the bank."""
    G, S, k = topi.shape
    dev = topi.device
    order = topi.transpose(1, 2).reshape(G, 1, k * S)
    onehot = (order == torch.arange(n_experts, device=dev)[:, None]).int()  # (G, E, k*S)
    before = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    pos = before.gather(1, order).reshape(G, k, S).transpose(1, 2)  # (G, S, k)
    local = topi - first
    placed = live & (pos < capacity) & (local >= 0) & (local < n_local)
    bank, n = n_local * G * capacity, G * S * k
    flat = (local * G + torch.arange(G, device=dev)[:, None, None]) * capacity + pos
    choices = torch.arange(n, device=dev)
    dest = torch.where(placed, flat, bank).reshape(n)
    choice_of = torch.full((bank + n,), n, dtype=torch.int64, device=dev)
    choice_of.scatter_(0, torch.where(dest < bank, dest, bank + choices), choices)
    return dest.reshape(G * S, k).int(), choice_of[:bank].int()


def _rows(t: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """t's rows at ``index``, a zero row where it equals len(t)."""
    return F.pad(t, (0, 0, 0, 1)).index_select(0, index.reshape(-1))


class _Dispatch(torch.autograd.Function):
    """The bank's rows, x[token of each slot] (a zero row where empty); the
    backward is the transpose, through ``slot_of``: grad_x[t] = sum_j
    grad[slot_of[t, j]]."""

    @staticmethod
    def forward(ctx, x, slot_of, choice_of):
        ctx.save_for_backward(slot_of)
        return _rows(x, torch.div(choice_of, slot_of.shape[1], rounding_mode="floor"))

    @staticmethod
    def backward(ctx, grad):
        (slot_of,) = ctx.saved_tensors
        T, k = slot_of.shape
        return _rows(grad, slot_of).reshape(T, k, -1).sum(dim=1), None, None


class _Combine(torch.autograd.Function):
    """y[t] = sum_j w[t, j] * out[slot_of[t, j]] (a dropped choice adds 0),
    summed in float32 and cast to out's dtype; the backward gathers through
    ``choice_of``: grad_out[s] = w(s) * grad_y[token of s] (0 where empty),
    and grad_w[t, j] = <grad_y[t], out[slot_of[t, j]]>."""

    @staticmethod
    def forward(ctx, out, w, slot_of, choice_of):
        ctx.save_for_backward(out, w, slot_of, choice_of)
        T, k = slot_of.shape
        picked = _rows(out, slot_of).reshape(T, k, -1).float()
        return (w.float()[..., None] * picked).sum(dim=1).to(out.dtype)

    @staticmethod
    def backward(ctx, grad):
        out, w, slot_of, choice_of = ctx.saved_tensors
        T, k = slot_of.shape
        g = grad.float()
        picked = _rows(out, slot_of).reshape(T, k, -1).float()
        grad_w = (picked * g[:, None]).sum(dim=-1).to(w.dtype)
        scaled = (w.float()[..., None] * g[:, None]).to(out.dtype).reshape(T * k, -1)
        return _rows(scaled, choice_of), grad_w, None, None


def _route(cfg: MoEUITConfig, p: MoE, x: torch.Tensor) -> _Routes:
    """``moe_mlp``'s routing: router, float32 softmax, top-k (renormalized
    weights), the groups holding this rank's tokens and their slot maps."""
    B, N, D = x.shape
    E, k = cfg.n_experts, cfg.top_k
    rows = current_rows()
    world = 1 if rows is None else rows.world
    S = _group_size(cfg, B * world, N)
    C = max(1, min(int(math.ceil(k * S / E * cfg.capacity_factor)), k * S))

    gates = torch.softmax(torch.einsum("td,de->te", x.reshape(B * N, D).float(),
                                       p.router.kernel), dim=-1)
    topv, topi = _top_k(gates, k)  # (T, k)
    topv = topv / topv.sum(dim=-1, keepdim=True)
    xt = x.reshape(B * N, D)
    if p.ep is not None:  # x and the combine weights reach every rank's banks
        xt, topv = copy_to(xt, p.ep.group), copy_to(topv, p.ep.group)
    all_topi, first = topi, 0
    if world > 1:  # every token's choices in the global order, over any group of Rows
        spread = torch.zeros((world, B * N, k), dtype=topi.dtype, device=topi.device)
        spread[rows.rank] = topi
        all_topi, first = rows.all_reduce(spread).reshape(-1, k), rows.rank * B * N
    # the groups holding this rank's tokens, the others' tokens zero rows
    g0, g1 = first // S, -(-(first + B * N) // S)
    pad = (0, 0, first - g0 * S, g1 * S - first - B * N)

    def fill(t):
        return F.pad(t, pad) if pad[2] or pad[3] else t

    xt, w = fill(xt), fill(topv)
    topi = all_topi[g0 * S:g1 * S].reshape(g1 - g0, S, k)
    slot_of, choice_of = _slot_maps(topi, w.detach().reshape(g1 - g0, S, k) > 0, E, C,
                                    0 if p.ep is None else p.ep.first, p.fc1.kernel.shape[0])
    f = (all_topi[:, 0, None] == torch.arange(E, device=x.device)).float().mean(dim=0)
    P = gates.mean(dim=0) if rows is None else rows.mean(gates.mean(dim=0))
    return _Routes(xt, w, slot_of, choice_of, pad[2], E * torch.sum(f * P))


def _moe_mlp(cfg: MoEUITConfig, p: MoE, x: torch.Tensor):
    """``moe_mlp``'s forward, its four inner spans."""
    B, N, D = x.shape
    cdt = uit.compute_dtype(cfg.base)
    with span("moe.route"):
        r = _route(cfg, p, x)
    with span("moe.dispatch"):
        expert_in = _Dispatch.apply(r.xt.to(cdt), r.slot_of, r.choice_of).reshape(
            p.fc1.kernel.shape[0], -1, D)  # (E, G*C, D)
    with span("moe.experts"):
        h = ACTIVATIONS[cfg.base.act](
            torch.einsum("ecd,edh->ech", expert_in, p.fc1.kernel.to(cdt))
            + p.fc1.bias.to(cdt)[:, None, :])
        out_e = (torch.einsum("ech,ehd->ecd", h, p.fc2.kernel.to(cdt))
                 + p.fc2.bias.to(cdt)[:, None, :])
    with span("moe.combine"):
        y = _Combine.apply(out_e.reshape(-1, D), r.w.to(cdt), r.slot_of, r.choice_of)
    if p.ep is not None:
        y = reduce_from(y, p.ep.group)
    y = y[r.row0:r.row0 + B * N]
    return y.reshape(B, N, D).to(x.dtype), r.aux


@torch.no_grad()
def routing_stats(cfg: MoEUITConfig, p: MoE, x: torch.Tensor) -> dict:
    """How often one block's routing places a token, for its input x (B, N,
    D), read on the host (outside any step): ``kept_share``, the placed
    (token, choice) pairs over k * B * N, and ``filled_share``, the filled
    slots over the bank's (n_local * G * C); this rank's own under expert
    parallelism or ``Rows``."""
    r = _route(cfg, p, x)
    bank = r.choice_of.numel()
    placed = int((r.slot_of < bank).sum())
    return {"kept_share": placed / (cfg.top_k * x.shape[0] * x.shape[1]),
            "filled_share": placed / bank}


# ------------------------------------------------------------------- forward

def block_forward(cfg: MoEUITConfig, blk, x: torch.Tensor, *, dpr_i: float = 0.0,
                  train: bool = False, generator=None):
    """uit.block_forward with the MLP routed -> (tokens, aux_loss)."""
    return uit.block_forward(cfg.base, blk, x, dpr_i=dpr_i, train=train, generator=generator,
                             mlp_fn=lambda b_, h: moe_mlp(cfg, b_.moe, h))


def _encode(cfg: MoEUITConfig, model: MoEUiT, mel: torch.Tensor, *, train: bool = False,
            generator=None):
    """(B, n_mels, T<=target) mel -> ((B, outputdim) probs, mean aux,
    new_state). Train mode: batch-stat init_bn whose running statistics
    (momentum 0.01) come back in new_state keyed by buffer name, dropout
    and drop-path from ``generator``; eval: inference BN, new_state {}."""
    b = cfg.base
    new_state = {}
    if train and b.init_bn:
        x, bn = batch_norm_train(model.init_bn, mel, axis=-2, momentum=0.01)
        new_state = {f"init_bn.{k}": v for k, v in bn.items()}
    else:
        x = uit.apply_init_bn(b, model, mel)
    x = uit.patch_embed(b, model.patch_embed, x)
    x, _ = uit._prepare_tokens(b, model, x, train=train, generator=generator)
    aux_total = 0.0
    dpr = torch.linspace(0.0, b.drop_path_rate, b.depth, dtype=torch.float64).tolist()
    for blk, rate in zip(model.blocks, dpr):
        x, aux = block_forward(cfg, blk, x, dpr_i=rate, train=train, generator=generator)
        aux_total = aux_total + aux
    x = layer_norm(model.norm, x.float(), eps=1e-6)
    return uit.forward_head(b, model, x), aux_total / b.depth, new_state


def forward_with_aux(cfg: MoEUITConfig, model: MoEUiT, wav: torch.Tensor, *,
                     train: bool = False, generator=None,
                     frontend_fn: Optional[Callable] = None):
    """(B, T_wav) waveform -> ((B, outputdim) probs, aux_loss, new_state).
    Eval: long clips take the reference crop rule (windows fold into the
    batch; aux averages over crops with everything else) and new_state is
    {}. Train (single window, as uit.forward's train path): init_bn on
    batch statistics, new_state its updated running statistics."""
    b = cfg.base
    if b.mel_layout != "bft":
        raise ValueError("the MoE forward runs the canonical 'bft' layout")
    fe = frontend_fn or (lambda w: uit.log_mel_spectrogram(w, b.frontend))
    mel = fe(wav)
    if not train and mel.shape[-1] > b.target_length:
        crops, n_crops = uit.chunk_long_mel(b, mel)
        probs, aux, _ = _encode(cfg, model, crops)
        probs = probs.reshape(-1, n_crops, b.outputdim)
        return uit._reduce_crops(b, probs, 1), aux, {}
    return _encode(cfg, model, mel, train=train, generator=generator)


def forward(cfg: MoEUITConfig, model: MoEUiT, wav: torch.Tensor, *,
            frontend_fn: Optional[Callable] = None) -> torch.Tensor:
    """Registry-facing eval forward: (B, T_wav) -> (B, outputdim) probs."""
    return forward_with_aux(cfg, model, wav, frontend_fn=frontend_fn)[0]


def uit_xs_moe(outputdim: int = 527, target_length: int = 1012, n_experts: int = 8,
               top_k: int = 2, capacity_factor: float = 2.0,
               router_aux_weight: float = 1e-2, group_size: Optional[int] = None,
               **kwargs) -> MoEUITConfig:
    """uit_xs geometry (D=128, depth 12, bneck attention, ReLU, 'mean'
    pooling) with the block MLPs routed over ``n_experts`` experts."""
    return MoEUITConfig(
        base=uit.uit_xs(outputdim=outputdim, target_length=target_length, **kwargs),
        n_experts=n_experts, top_k=top_k, capacity_factor=capacity_factor,
        router_aux_weight=router_aux_weight, group_size=group_size)
