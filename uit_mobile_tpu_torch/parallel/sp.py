"""Sequence (context) parallelism, counterpart of
``uit_mobile_tpu/parallel/sp.py``: ring attention over a 'seq' mesh axis.

The scaling path for a long-context variant whose token axis outgrows one
card; the shipped family (24 tokens a 1 s window) serves on the data
parallel layouts. Each rank of the 'seq' axis holds B x N/S tokens:

- every per-token op (LayerNorm, the MLP, LayerScale, the residuals, the
  qkv and proj linears, weights replicated) runs on the local tokens with
  no communication; only attention mixes tokens;
- attention is a ring: each rank computes q/k/v of its tokens, then its
  K/V blocks (every head at once) move S-1 hops around the ring (rank i
  sends to i+1: 2 sends a hop, K and V) while the flash-attention
  recurrence (running max m, denominator l, numerator o) folds one
  (n_loc x n_loc) logit tile a hop; a final fold takes the last block
  without a rotation. The softmax over the whole key axis is exact up to
  float32 summation order, and no (N x N) tensor exists on any rank;
- the mean pool is one all-reduce of local token sums over 'seq', divided
  by the tokens present (local x S; a clip shorter than target_length has
  fewer), and the head runs on every rank.

Composes with a 'data' axis (``data_axis``): the batch's rows shard over
it, the ring stays on 'seq'. Each rank runs the frontend (the kernel, with
``frontend_fn`` from ``ops.mel.make_frontend_fn``) on its rows. Eval only,
the single-window 'bft' path, as in JAX. (The models import this
package, so this module imports the models inside its functions.)
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from .collectives import exchange
from .mesh import GridMesh, make_grid_mesh
from .rows import sharded


def make_seq_mesh(n_shards: int, axis: str = "seq", device="cuda") -> GridMesh:
    """The process group as a 1-D 'seq' mesh (consecutive ranks are ring
    neighbours)."""
    return make_grid_mesh({axis: n_shards}, device)


def _ring_attention(p, x_loc: torch.Tensor, *, num_heads: int, scale: float, inner_dim: int,
                    mesh: GridMesh, axis: str) -> torch.Tensor:
    """Exact MHSA over the whole (sharded) token axis: (B, n_loc, D) local
    tokens -> (B, n_loc, D), the K/V blocks rotating around ``axis``; the
    caller's softmax scale (the full-dim head quirk)."""
    from ..models.common import linear

    B, n_loc, _ = x_loc.shape
    S = mesh.shape[axis]
    h, hd = num_heads, inner_dim // num_heads
    qkv = linear(p.qkv, x_loc)  # (B, n_loc, 3*inner)

    def split_heads(t):  # (B, n_loc, inner) -> (B, h, n_loc, hd), head i = columns i*hd...
        return t.reshape(B, n_loc, h, hd).transpose(1, 2).float()

    q = split_heads(qkv[..., :inner_dim])
    k = split_heads(qkv[..., inner_dim:2 * inner_dim])
    v = split_heads(qkv[..., 2 * inner_dim:])

    def fold(k_blk, v_blk, m, l, o):
        logits = (q @ k_blk.transpose(-1, -2)) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1))
        c = torch.exp(m - m_new)
        pexp = torch.exp(logits - m_new[..., None])
        return m_new, c * l + pexp.sum(dim=-1), c[..., None] * o + pexp @ v_blk

    m = torch.full((B, h, n_loc), float("-inf"), device=q.device)
    l = torch.zeros((B, h, n_loc), device=q.device)
    o = torch.zeros((B, h, n_loc, hd), device=q.device)
    nxt, prev = mesh.rank_at(axis, mesh.coords[axis] + 1), mesh.rank_at(axis, mesh.coords[axis] - 1)
    for _ in range(S - 1):  # S-1 (fold, rotate) hops, then the last fold
        m, l, o = fold(k, v, m, l, o)
        k, v = exchange([(k, nxt), (v, nxt)], [(k, prev), (v, prev)], mesh.group(axis))
    m, l, o = fold(k, v, m, l, o)
    out = (o / l[..., None]).transpose(1, 2).reshape(B, n_loc, inner_dim)
    return linear(p.proj, out.to(x_loc.dtype))


def _sp_block(cfg, blk, x: torch.Tensor, *, mesh: GridMesh, axis: str) -> torch.Tensor:
    """``uit.block_forward``'s eval math on a token shard, its casting for
    bfloat16 included: attention is the ring, the rest is per token."""
    from ..models import uit
    from ..models.common import layer_norm, mlp

    cdt = uit.compute_dtype(cfg)
    cast = (lambda m: m) if cdt == torch.float32 else (lambda m: uit.Cast(m, cdt))  # noqa: E731
    h = layer_norm(blk.norm1, x.float(), eps=1e-6).to(cdt)
    h = _ring_attention(cast(blk.attn), h, num_heads=cfg.num_heads, scale=cfg.attn_scale,
                        inner_dim=cfg.inner_dim, mesh=mesh, axis=axis)
    if hasattr(blk, "ls1"):
        h = h * blk.ls1.gamma.to(cdt)
    x = x + h
    h = layer_norm(blk.norm2, x.float(), eps=1e-6).to(cdt)
    h = mlp(cast(blk.mlp), h, act=cfg.act)
    if hasattr(blk, "ls2"):
        h = h * blk.ls2.gamma.to(cdt)
    return x + h


def sequence_parallel_forward(cfg, model, mesh: GridMesh, *, seq_axis: str = "seq",
                              data_axis: Optional[str] = None,
                              frontend_fn: Optional[Callable] = None) -> Callable:
    """An eval forward ``fn(wav) -> probs`` with the token axis sharded over
    ``mesh[seq_axis]`` (and the batch over ``data_axis`` on a 2-D mesh):
    every rank passes the global batch and gets the global probabilities.
    Needs pooling='mean' (a cls token is sequence-global), a non-causal
    model, the 'bft' layout and N % S == 0; clips of at most target_length
    (longer clips are batch on the data-parallel layouts). On an NCCL mesh
    on the card, a CUDA graph per batch shape (``GridMesh.dispatch``: the
    ring's sends and receives in the graph; ``fn.eager``, ``fn.graphs``)."""
    from ..models import uit
    from ..models.common import layer_norm

    S = mesh.shape[seq_axis]
    if cfg.pooling != "mean":
        raise ValueError("sequence_parallel_forward: pooling='mean' only")
    if cfg.causal:
        raise ValueError("ring attention here is non-causal only")
    if cfg.mel_layout != "bft":
        raise ValueError("sequence_parallel_forward runs the canonical 'bft' forward; the "
                         "tfb/btf serving layouts are DP-only")
    fg, tg = cfg.grid_size
    if (fg * tg) % S:
        raise ValueError(f"{fg * tg} tokens must divide {S} sequence shards")
    model = model.to(mesh.device)
    fe = frontend_fn or (lambda w: uit.log_mel_spectrogram(w, cfg.frontend))
    s = mesh.coords[seq_axis]

    def fwd(wav):
        local, rows = mesh.shard_rows(wav, data_axis)
        with torch.inference_mode(), sharded(rows):
            mel = fe(local)  # (B, n_mels, T)
            if mel.shape[-1] > cfg.target_length:
                raise ValueError("sequence_parallel_forward is the single-window serving "
                                 "path; chunk long clips upstream (chunk_long_mel) or use "
                                 "the DP layouts")
            x = uit.apply_init_bn(cfg, model, mel)
            x = uit.patch_embed(cfg, model.patch_embed, x)
            x, _ = uit._prepare_tokens(cfg, model, x)
            if x.shape[1] % S:
                raise ValueError(f"{x.shape[1]} tokens must divide {S} sequence shards")
            n_loc = x.shape[1] // S
            x = x[:, s * n_loc:(s + 1) * n_loc]
            for blk in model.blocks:
                x = _sp_block(cfg, blk, x, mesh=mesh, axis=seq_axis)
            x = layer_norm(model.norm, x.float(), eps=1e-6)
            # the mean over the tokens present (local x S), as the dense x.mean(1)
            pooled = x.sum(dim=1)
            if S > 1:
                dist.all_reduce(pooled, group=mesh.group(seq_axis))
            probs = uit.forward_head(cfg, model, (pooled / (n_loc * S))[:, None, :])
        return mesh.gather_rows(probs, data_axis)

    return mesh.dispatch(fwd)
