"""Pipeline parallelism, counterpart of ``uit_mobile_tpu/parallel/pp.py``:
GPipe over a 'pipe' mesh axis for the UiT block stack.

The scaling path for a deep variant whose blocks outgrow one card; the
shipped family serves on the data-parallel layouts. The blocks' weights
are stacked on the host along a leading depth axis
(``stack_block_params``), and each of S stages takes only its depth/S
consecutive blocks to its card. The GPipe schedule runs S + M - 1 ticks
over M microbatches: at tick t stage s runs microbatch t - s (when there
is one; JAX's bubble ticks compute on zeros and discard them, here they
compute nothing), then hands its activations one stage down (one send a
tick of work; NCCL point to point on the card, through the host on gloo).
The last stage collects the microbatches and one all-reduce over 'pipe'
replicates them, so the embedding before the blocks and the final norm
and head run on every rank. Every rank runs the frontend (the kernel, with
``frontend_fn`` from ``ops.mel.make_frontend_fn``) on its rows.

Composes with a 'data' axis (``data_axis``): each data rank takes its
contiguous rows of the batch and microbatches them; rows are independent
in eval (the top_db clamp's max reduced over 'data'), so the output is
JAX's. Eval only, the single-window 'bft' path, as in JAX. (The models
import this package, so this module imports the models inside its
functions.)
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import exchange
from .mesh import GridMesh, make_grid_mesh
from .rows import sharded


def make_pipe_mesh(n_stages: int, axis: str = "pipe", device="cuda") -> GridMesh:
    """The process group as a 1-D 'pipe' mesh (consecutive ranks are
    consecutive stages)."""
    return make_grid_mesh({axis: n_stages}, device)


def stack_block_params(model) -> dict:
    """The blocks' parameters stacked on the host: in-block name -> numpy
    array (depth, ...). Every block has the same structure (all or none
    hold LayerScale). On the host, so the stack never sits on one card."""
    blocks = [dict(b.named_parameters()) for b in model.blocks]
    return {k: np.stack([b[k].detach().cpu().numpy() for b in blocks]) for k in blocks[0]}


def _stage_model(cfg, model, stacked: dict, stage: int, n_stages: int, device):
    """The stage's container: the model's embedding, norm and head, and its
    depth/S blocks from the stacked slice, on ``device``."""
    from ..models import uit

    per = cfg.depth // n_stages
    stage_model = uit.UiT(dataclasses.replace(cfg, depth=per))
    sd = {k: v for k, v in model.state_dict().items() if not k.startswith("blocks.")}
    for j in range(per):
        sd.update({f"blocks.{j}.{k}": torch.from_numpy(v[stage * per + j])
                   for k, v in stacked.items()})
    stage_model.load_state_dict(sd)
    return stage_model.to(device).eval()


def pipeline_forward(cfg, model, mesh: GridMesh, *, n_microbatches: Optional[int] = None,
                     pipe_axis: str = "pipe", data_axis: Optional[str] = None,
                     frontend_fn: Optional[Callable] = None) -> Callable:
    """An eval forward ``fn(wav) -> probs`` with the block stack pipelined
    over ``mesh[pipe_axis]`` (and the batch over ``data_axis`` on a 2-D
    mesh): every rank passes the global batch and gets the global
    probabilities. ``n_microbatches`` defaults to the stage count; the batch
    must divide by it, and each microbatch's rows by the data axis. Clips
    of at most target_length. On an NCCL mesh on the card, a CUDA graph per
    batch shape (``GridMesh.dispatch``: the S + M - 1 ticks' hand-offs one
    replay; ``fn.eager``, ``fn.graphs``)."""
    from ..models import uit
    from ..models.common import layer_norm

    S = mesh.shape[pipe_axis]
    if cfg.depth % S:
        raise ValueError(f"depth {cfg.depth} must divide into {S} pipeline stages")
    M = int(n_microbatches or S)
    if cfg.mel_layout != "bft":
        raise ValueError("pipeline_forward pipelines the canonical 'bft' forward; the "
                         "tfb/btf serving layouts are DP-only")
    s = mesh.coords[pipe_axis]
    stage = _stage_model(cfg, model, stack_block_params(model), s, S, mesh.device)
    fe = frontend_fn or (lambda w: uit.log_mel_spectrogram(w, cfg.frontend))
    group = mesh.group(pipe_axis)
    nxt, prev = mesh.rank_at(pipe_axis, s + 1), mesh.rank_at(pipe_axis, s - 1)

    def run_stage(x):
        for blk in stage.blocks:
            x = uit.block_forward(cfg, blk, x)
        return x

    def fwd(wav):
        B = torch.as_tensor(wav).shape[0]
        if B % M:
            raise ValueError(f"microbatch count {M} must divide the batch ({B})")
        if data_axis:
            nd = mesh.shape[data_axis]
            if (B // M) % nd:
                raise ValueError(f"microbatch rows {B // M} (batch {B} / {M} microbatches) "
                                 f"must divide the '{data_axis}' axis ({nd}) — raise the "
                                 f"batch or lower the microbatch count")
        local, rows = mesh.shard_rows(wav, data_axis)
        with torch.inference_mode(), sharded(rows):
            mel = fe(local)  # (B, n_mels, T)
            if mel.shape[-1] > cfg.target_length:
                raise ValueError("pipeline_forward is the single-window serving path; chunk "
                                 "long clips upstream (chunk_long_mel) or use the DP layouts")
            x = uit.apply_init_bn(cfg, stage, mel)
            x = uit.patch_embed(cfg, stage.patch_embed, x)
            x, _ = uit._prepare_tokens(cfg, stage, x)
            b, N, D = x.shape
            xs = x.reshape(M, b // M, N, D)
            out = torch.zeros_like(xs)
            inp = None
            for t in range(S + M - 1):
                mb = t - s  # this stage's microbatch at tick t
                y = None
                if 0 <= mb < M:
                    y = run_stage(xs[mb] if s == 0 else inp)
                    if s == S - 1:
                        out[mb] = y
                sends = [(y, nxt)] if y is not None and s < S - 1 else []
                recvs = [(xs[0], prev)] if s > 0 and 0 <= t - (s - 1) < M else []
                got = exchange(sends, recvs, group)
                inp = got[0] if got else None
            # replicate the last stage's outputs over the pipe
            if S > 1:
                dist.all_reduce(out, group=group)
            x = layer_norm(stage.norm, out.reshape(b, N, D).float(), eps=1e-6)
            probs = uit.forward_head(cfg, stage, x)
        return mesh.gather_rows(probs, data_axis)

    return mesh.dispatch(fwd)
