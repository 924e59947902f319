"""Best-available eval forward dispatch, counterpart of
``uit_mobile_tpu/ops/pipeline.py``.

``make_forward_fn`` is the one place that encodes the layout/precision
policy: where the kernel is available (the model lives on a CUDA device),
the fused mel kernel feeds the UiT encoder in the transposed 'tfb' layout
with init_bn folded into the patch embed, and other families (MobileNetV2,
the MoE UiT) the canonical mel through 'tfb_to_bft'; elsewhere the rfft reference
frontend feeds the canonical 'bft' path. A list of models is an ensemble:
the frontend runs once and the member probabilities are averaged.

On the card every forward here is a CUDA graph per input shape
(``ops/graphs.py``), as the JAX package jits each: ``make_scanned_forward``
captures the K forwards of a (K, B, T) block as one graph. On the CPU they
run eagerly.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from .. import models
from ..models.moe import MoEUITConfig
from ..models.uit import UITConfig
from ..utils.device import resolve_device
from .graphs import graphed_forward
from .mel import make_frontend_fn


def _members(cfg, model) -> list:
    """``model`` as a list of members (a single model is a list of one);
    an ensemble must be a non-empty list of models of one architecture."""
    if not isinstance(model, (list, tuple)):
        return [model]
    if not model:
        raise ValueError("an ensemble forward needs a non-empty list of models")
    shapes = [[(n, tuple(p.shape)) for n, p in m.named_parameters()] for m in model]
    if any(type(m) is not type(model[0]) or s != shapes[0] for m, s in zip(model, shapes)):
        raise ValueError(f"ensemble members must share one model config ({cfg}): their "
                         f"parameter names or shapes differ")
    return list(model)


def _policy(cfg, model, use_kernel, precision, top_db_mode, btf, framewise=False,
            frontend_fn=None):
    """-> (members, device, run config, frontend fn, use_kernel). A caller's
    ``frontend_fn`` runs with ``cfg`` as it stands."""
    members = _members(cfg, model)
    device = resolve_device(next(members[0].parameters()).device)
    if frontend_fn is not None:
        return members, device, cfg, frontend_fn, use_kernel
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    uit_family = isinstance(cfg, UITConfig)
    if not use_kernel or btf is False or framewise:
        layout = "bft"
    else:
        # bft consumers (MobileNetV2, the MoE UiT) take the transposed
        # kernel plus one transpose back where that is bitwise the row kernel
        layout = "tfb" if uit_family else "tfb_to_bft"
    fe_cfg = cfg.frontend
    if top_db_mode is not None:
        fe_cfg = dataclasses.replace(fe_cfg, top_db_mode=top_db_mode)
    # the model config's mel_layout is always pinned to the frontend's
    # actual layout (non-UiT configs have no layout branch)
    if uit_family:
        run_cfg = dataclasses.replace(cfg, mel_layout=layout, frontend=fe_cfg)
    elif isinstance(cfg, MoEUITConfig):  # its frontend lives in its UiT base
        run_cfg = dataclasses.replace(cfg, base=dataclasses.replace(cfg.base, frontend=fe_cfg))
    else:
        run_cfg = dataclasses.replace(cfg, frontend=fe_cfg)
    frontend = make_frontend_fn(fe_cfg, use_kernel=use_kernel, precision=precision,
                                layout=layout)
    return members, device, run_cfg, frontend, use_kernel


def ensemble_forward(members: list, run_cfg, frontend, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) wave -> (B, C) probs of one member, or the mean of the
    members' probabilities over one frontend run (an ensemble)."""
    if len(members) == 1:
        return models.forward(run_cfg, members[0], wav, frontend_fn=frontend)
    mel = frontend(wav)
    probs = [models.forward(run_cfg, m, wav, frontend_fn=lambda _: mel) for m in members]
    return torch.stack(probs).mean(dim=0)


def make_forward_fn(cfg, model, use_kernel: Optional[bool] = None,
                    precision: str = "exact", top_db_mode: Optional[str] = None,
                    btf: Optional[bool] = None, frontend_fn: Optional[Callable] = None):
    """Eval forward fn(wav) -> probs on the model's device.

    model: one model, or a list of models of one config (an ensemble: the
    frontend runs once and fn returns the mean of the member probabilities).
    use_kernel: None = the fused kernel whenever the model is on CUDA.
    With use_kernel=True on a CPU model the kernel's plain version runs.
    precision: 'exact' (parity grade) or 'fast' (3-pass bf16 DFT; serving).
    top_db_mode: override the frontend's dB-clamp reference ('per_sample'
    for serving isolation); None keeps the config's mode.
    btf: None = the transposed-kernel routes whenever the kernel runs ('tfb'
    for UiT, 'tfb_to_bft' for other families); False pins the plain 'bft'
    chain. frontend_fn: the caller's frontend (a trainer's validation runs
    the one its step runs) with ``cfg`` as it stands; the other options are
    then unused. ``wav`` is a (B, T) float32 or int16 tensor or array.
    fn.uses_kernel and fn.top_db_mode say which frontend runs; fn.body is
    the forward of a device batch and fn.graphs its ``GraphedFn`` on the
    card (None on the CPU); fn.eager is fn never graphed; fn.batch_global
    whether a row of the output depends on other rows of the batch
    (``_batch_global``): the data-parallel shards of parallel/mesh.py then
    meet in a collective inside it, and run fn.eager."""
    members, device, run_cfg, frontend, use_kernel = _policy(
        cfg, model, use_kernel, precision, top_db_mode, btf, frontend_fn=frontend_fn)

    def body(wav):
        return ensemble_forward(members, run_cfg, frontend, wav)

    return _device_fn(body, device, use_kernel, run_cfg, _batch_global(run_cfg, frontend_fn))


def _batch_global(run_cfg, frontend_fn) -> bool:
    """Whether a row of the forward's output depends on other rows of its
    batch: the batch-global 'torch' top_db clamp, the MoE's routing groups
    (the global batch's), or a caller's frontend (not known here)."""
    fe = run_cfg.frontend
    return (frontend_fn is not None or isinstance(run_cfg, MoEUITConfig)
            or (fe.top_db is not None and fe.top_db_mode == "torch"))


def _device_fn(body, device, use_kernel, run_cfg, batch_global):
    """``body`` on the batch moved to ``device``, graphed on the card
    (``graphed_forward``), with the attributes make_forward_fn lists."""
    fn = graphed_forward(body, device)
    fn.uses_kernel = use_kernel
    fn.top_db_mode, fn.batch_global = run_cfg.frontend.top_db_mode, batch_global
    fn.body, fn.device = body, device
    return fn


def make_framewise_fn(cfg, model, use_kernel: Optional[bool] = None,
                      precision: str = "exact", top_db_mode: Optional[str] = None,
                      frontend_fn: Optional[Callable] = None):
    """Temporal-tagging forward fn(wav) -> (probs (B, S, C) on the model's
    device, times (S, 2) float64 numpy seconds), on the bft layout; a list
    of models averages the member probabilities over one frontend run (the
    times depend on the config alone). ``frontend_fn`` as in
    ``make_forward_fn``."""
    members, device, run_cfg, frontend, use_kernel = _policy(
        cfg, model, use_kernel, precision, top_db_mode, None, framewise=True,
        frontend_fn=frontend_fn)

    def body(wav):
        if len(members) == 1:
            return models.apply_framewise(run_cfg, members[0], wav, frontend_fn=frontend)
        mel = frontend(wav)
        outs = [models.apply_framewise(run_cfg, m, wav, frontend_fn=lambda _: mel)
                for m in members]
        return torch.stack([p for p, _ in outs]).mean(dim=0), outs[0][1]

    return _device_fn(body, device, use_kernel, run_cfg, _batch_global(run_cfg, frontend_fn))


def make_scanned_forward(fwd_fn):
    """(K, B, T) wav block -> (K, B, C) probs, the K batches run one after
    another through ``fwd_fn`` (a ``make_forward_fn`` forward): on the card
    one CUDA graph of the K forwards (one replay a block, as ``lax.scan`` is
    one program in the JAX package)."""
    body, device = fwd_fn.body, fwd_fn.device

    def scanned_body(block):
        return torch.stack([body(block[k]) for k in range(block.shape[0])])

    return graphed_forward(scanned_body, device)


def make_block_builder(k: int):
    """-> ``mkblock(a, b, offset)``: a (K, B, T) block for
    ``make_scanned_forward`` built on the device from two uploaded (B, T)
    batches, batch i the rows of ``a`` (even i) or ``b`` (odd i) rolled by
    ``offset + i``, so that the K batches differ. Benchmark plumbing: it
    keeps the upload of a (K, B, T) block out of the set-up."""

    def mkblock(a: torch.Tensor, b: torch.Tensor, offset: int) -> torch.Tensor:
        return torch.stack([torch.roll(a if i % 2 == 0 else b, offset + i, dims=0)
                            for i in range(k)])

    return mkblock
