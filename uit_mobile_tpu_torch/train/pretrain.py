"""Masked-autoencoder (MAE) pretraining of the UiT encoder, counterpart of
``uit_mobile_tpu/train/pretrain.py``.

Masked-spectrogram-patch pretraining on unlabeled audio (MAE, He et al.
2021, on 16x16 mel patches):
- log-mel (the plain rfft frontend, as in the JAX package) -> init_bn on
  batch statistics -> patch embedding + factorized pos embeds -> (B, L, D);
- a random ``mask_ratio`` of the patches is dropped per sample (``noise``
  (B, L) uniform, argsort: the first ``num_keep`` of the shuffle are kept);
  the encoder blocks run on the kept patches only;
- a light decoder (mask tokens in the dropped places, its own pos embeds,
  a few full-attention blocks) predicts every patch's mel pixels; the loss
  is the MSE on the masked patches against per-patch-normalized targets.

The model (``MAE``) is a UiT container with the decoder under ``mae``, so
the snapshot ``mae_pretrained.npz`` (the encoder's config, the full tree)
goes into the ``pretrained:`` shape-filtered load of either package's
Trainer, with the pos-embed retarget across target lengths (pretraining at
1012 frames -> fine-tuning at 102). ``forward`` takes the noise as an
argument, so a test can feed both packages the same draw; without it the
noise comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
import random as _random
import time
from pathlib import Path
from typing import Optional

import torch
from torch import nn

from .. import models
from ..ckpt.io import load_training_state, save_checkpoint, save_training_state
from ..data import DataLoader, UnlabeledRandomChunkedHDF5Dataset, read_tsv_data
from ..frontend import log_mel_spectrogram
from ..models import uit
from ..models.common import (LayerNorm, Linear, batch_norm_train, layer_norm, linear,
                             linear_init, mlp, multihead_attention)
from ..models.uit import UiT, UITConfig
from ..parallel import multihost
from ..parallel.mesh import dp_placement
from ..parallel.rows import Rows, global_sum, rand_rows, sharded
from ..utils import get_logger, resolve_device
from .schedule import cosine_with_warmup
from .steps import build_optimizer, find_ema_params, update_from_loss, wrap_optimizer

log = get_logger()


@dataclasses.dataclass(frozen=True)
class MAEConfig:
    encoder: UITConfig
    mask_ratio: float = 0.75
    decoder_depth: int = 2
    decoder_num_heads: int = 2

    @property
    def num_patches(self) -> int:
        fg, tg = self.encoder.grid_size
        return fg * tg

    @property
    def num_keep(self) -> int:
        return max(1, int(round(self.num_patches * (1.0 - self.mask_ratio))))


class MAEDecoder(nn.Module):
    """{mask_token, decoder_pos_embed, decoder_blocks, decoder_norm, pred}:
    full-attention blocks of width D with qkv biases."""

    def __init__(self, cfg: MAEConfig):
        super().__init__()
        e = cfg.encoder
        D = e.embed_dim
        block_cfg = dataclasses.replace(e, attention_type="Attention", qkv_bias=True,
                                        init_values=None)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, D))
        self.decoder_pos_embed = nn.Parameter(torch.zeros(cfg.num_patches, D))
        self.decoder_blocks = nn.ModuleList(uit.Block(block_cfg)
                                            for _ in range(cfg.decoder_depth))
        self.decoder_norm = LayerNorm(D)
        self.pred = Linear(D, e.patch_size * e.patch_size)


class MAE(UiT):
    """The UiT encoder's parameters (same names) plus the decoder as
    ``mae``; ``cfg`` stays the encoder's config."""

    def __init__(self, cfg: MAEConfig):
        super().__init__(cfg.encoder)
        self.mae_cfg = cfg
        self.mae = MAEDecoder(cfg)


@torch.no_grad()
def init(cfg: MAEConfig, generator: torch.Generator) -> MAE:
    """A CPU MAE: the encoder as ``models.uit.init`` draws it, then the
    decoder (trunc-normal linears, 0.02-normal mask token and pos embeds),
    from ``generator``."""
    model = MAE(cfg)
    own = model.state_dict()
    for k, v in uit.init(cfg.encoder, generator).state_dict().items():
        own[k].copy_(v)
    d = model.mae
    for blk in d.decoder_blocks:
        for lin in (blk.attn.qkv, blk.attn.proj, blk.mlp.fc1, blk.mlp.fc2):
            linear_init(generator, lin)
    d.mask_token.copy_(0.02 * torch.randn(d.mask_token.shape, generator=generator))
    d.decoder_pos_embed.copy_(0.02 * torch.randn(d.decoder_pos_embed.shape,
                                                 generator=generator))
    linear_init(generator, d.pred)
    return model


def _run_blocks(blocks, x, num_heads, scale, inner_dim, act):
    for blk in blocks:
        x = x + multihead_attention(blk.attn, layer_norm(blk.norm1, x, eps=1e-6),
                                    num_heads=num_heads, scale=scale, inner_dim=inner_dim)
        x = x + mlp(blk.mlp, layer_norm(blk.norm2, x, eps=1e-6), act=act)
    return x


def mel_patches(cfg: MAEConfig, mel_bn: torch.Tensor) -> torch.Tensor:
    """(B, F, T) normalized mel -> (B, L, ps*ps) pixel patches (the targets)."""
    B, F, T = mel_bn.shape
    ps = cfg.encoder.patch_size
    fg, tg = F // ps, T // ps
    x = mel_bn[:, : fg * ps, : tg * ps]
    return x.reshape(B, fg, ps, tg, ps).permute(0, 1, 3, 2, 4).reshape(B, fg * tg, ps * ps)


def forward(cfg: MAEConfig, model: MAE, wav: torch.Tensor, *,
            generator: Optional[torch.Generator] = None,
            noise: Optional[torch.Tensor] = None):
    """One masked-reconstruction forward -> (loss, new_state, {'mask': (B, L)
    1 on masked patches}). ``noise`` (B, L) sets the per-sample shuffle;
    without it it is drawn uniform from ``generator``."""
    e = cfg.encoder
    mel = log_mel_spectrogram(wav, e.frontend)
    new_state = {}
    if e.init_bn:
        x_bn, bn = batch_norm_train(model.init_bn, mel, axis=-2, momentum=0.01)
        new_state = {f"init_bn.{k}": v for k, v in bn.items()}
    else:
        x_bn = (mel + 10.0) / 40.0
    tokens = uit.patch_embed(e, model.patch_embed, x_bn)  # (B, fg, tg, D)
    B, fg, tg, D = tokens.shape
    tokens = tokens + model.time_pos_embed[None, None, :tg, :]
    tokens = tokens + model.freq_pos_embed[None, :, None, :]
    L = fg * tg
    tokens = tokens.reshape(B, L, D)

    if noise is None:
        if generator is None:
            raise ValueError("MAE masking needs noise= or a torch.Generator")
        noise = rand_rows(generator, (B, L), generator.device)
    noise = torch.as_tensor(noise).to(tokens.device)
    ids_shuffle = torch.argsort(noise, dim=1, stable=True)
    ids_restore = torch.argsort(ids_shuffle, dim=1, stable=True)
    keep = ids_shuffle[:, : cfg.num_keep]
    x_vis = torch.gather(tokens, 1, keep[:, :, None].expand(-1, -1, D))
    x_vis = _run_blocks(model.blocks, x_vis, e.num_heads, e.attn_scale, e.inner_dim, e.act)
    x_vis = layer_norm(model.norm, x_vis, eps=1e-6)

    m = model.mae
    full = torch.cat([x_vis, m.mask_token.expand(B, L - cfg.num_keep, D)], dim=1)
    full = torch.gather(full, 1, ids_restore[:, :, None].expand(-1, -1, D))
    full = full + m.decoder_pos_embed[None, :L, :]
    full = _run_blocks(m.decoder_blocks, full, cfg.decoder_num_heads,
                       (D // cfg.decoder_num_heads) ** -0.5, D, e.act)
    pred = linear(m.pred, layer_norm(m.decoder_norm, full, eps=1e-6))

    target = mel_patches(cfg, x_bn)
    mu = target.mean(dim=-1, keepdim=True)
    var = target.var(dim=-1, keepdim=True, unbiased=False)
    target = (target - mu) / torch.sqrt(var + 1e-6)
    mask = torch.ones(B, L, device=tokens.device).scatter(1, keep, 0.0)
    per_patch = ((pred - target) ** 2).mean(dim=-1)
    loss = global_sum((per_patch * mask).sum()) / torch.clamp(global_sum(mask.sum()), min=1.0)
    return loss, new_state, {"mask": mask}


def make_mae_step(cfg: MAEConfig, model: MAE, optimizer, rows: Optional[Rows] = None):
    """-> ``step(wav, generator=None, noise=None) -> loss``: forward, backward
    and the optimizer update (no clipping, as in the JAX step). ``rows``:
    ``wav`` (and ``noise``) are this rank's share of a global batch
    (``parallel.rows``); the step is the global batch's on every rank."""

    def step(wav, generator=None, noise=None):
        with sharded(rows):
            loss, new_state, _ = forward(cfg, model, wav, generator=generator, noise=noise)
            update_from_loss(model, optimizer, loss, new_state)
        return loss.detach()

    return step


def _pretrain_outdir(c: dict) -> Path:
    return Path(c.get("outputpath", "experiments")) / "mae" / str(c.get("model", "uit_xs"))


def pretrain_from_config(config: dict, device="cuda", dataset=None) -> Path:
    """MAE pretraining on ``device`` -> the path of mae_pretrained.npz,
    written each epoch (the EMA parameters with ``ema_decay``), beside the
    resumable last.npz in ``<outputpath>/mae/<model>``. ``dataset``
    replaces the UnlabeledRandomChunkedHDF5Dataset over ``train_data`` (any
    map-style dataset of (wav crop, target, name)). ``resume`` and
    ``auto_resume: N`` as in the other trainers. ``multihost:`` scales it
    over processes as the weak trainer does (train/loop.py): a global
    batch_size, per-rank crops from a rank-offset seed, the global batch's
    step on every rank, rank 0 the only writer."""
    from .loop import start_multihost

    start_multihost(config, device)
    retries = int(config.get("auto_resume") or 0)
    config = dict(config)
    for attempt in range(retries + 1):
        try:
            return _pretrain_once(config, device, dataset)
        except Exception:
            last = _pretrain_outdir(config) / "last.npz"
            if attempt >= retries or not last.exists():
                raise
            log.exception(f"MAE pretraining crashed (attempt {attempt + 1}/{retries + 1}); "
                          f"auto-resuming from {last}")
            config["resume"] = str(last)
    raise AssertionError("unreachable")


def _read_manifest(path):
    if str(path).endswith((".tsv", ".csv")):
        return read_tsv_data(path)
    import pandas as pd

    return pd.read_csv(path, sep=r"\s+")


def _pretrain_once(c: dict, device, dataset) -> Path:
    model_args = dict(c.get("model_args", {}))
    model_args.setdefault("target_length", 1012)
    if model_args.get("mel_layout", "bft") != "bft":
        raise ValueError("MAE pretraining runs the canonical 'bft' mel path (its masked "
                         "reconstruction target is the bft mel); drop mel_layout from the "
                         "pretrain model_args")
    if dataset is None and not c.get("train_data"):
        raise ValueError("MAE pretraining needs train_data: a manifest of unlabeled clips "
                         "(filename, hdf5path)")
    dev = resolve_device(device)
    enc = models.get_model_config(c.get("model", "uit_xs"),
                                  outputdim=c.get("num_classes", 527), **model_args)
    cfg = MAEConfig(encoder=enc, mask_ratio=c.get("mask_ratio", 0.75),
                    decoder_depth=c.get("decoder_depth", 2))
    seed = c.get("seed", 42)
    model = init(cfg, torch.Generator().manual_seed(seed)).to(dev)
    # every rank runs this control flow; rank-offset seeds draw other crops
    rank, n_proc = multihost.process_index(), multihost.process_count()
    data_seed = seed + rank * 7919
    if multihost.is_initialized():
        log.info(f"multi-host MAE: process {rank}/{n_proc}")
    if dataset is None:
        chunk_seconds = (model_args["target_length"] * enc.frontend.hop_length
                         / enc.frontend.sample_rate)
        dataset = UnlabeledRandomChunkedHDF5Dataset(
            _read_manifest(c["train_data"]), chunk_length=c.get("chunk_length", chunk_seconds),
            rng=_random.Random(data_seed * 1000))
    global_bs = c.get("batch_size", 64)
    if global_bs % n_proc:
        raise ValueError(f"multi-host MAE pretraining needs batch_size ({global_bs}) "
                         f"divisible by the process count ({n_proc})")
    mesh, _, _ = dp_placement([global_bs], device=dev)
    rows = None
    if mesh is not None:
        log.info(f"data-parallel over {mesh.size} devices")
        rows = Rows([global_bs // n_proc], dev)
    loader = DataLoader(dataset, batch_size=global_bs // n_proc, shuffle=True,
                        num_workers=c.get("num_workers", 2), drop_last=True, seed=data_seed)

    epochs = c.get("epochs", 10)
    epoch_length = c.get("epoch_length") or len(loader)
    opt_args = dict(c.get("optimizer_args", {}))
    lr = opt_args.pop("lr", 1.5e-4)
    grad_accum = int(c.get("grad_accum", 1))
    schedule = cosine_with_warmup(lr, max(1, epochs * epoch_length // grad_accum),
                                  c.get("warmup_iters", 1000))
    spec = wrap_optimizer(build_optimizer(c.get("optimizer", "AdamW"), schedule, **opt_args),
                          ema_decay=c.get("ema_decay"), grad_accum=grad_accum)
    optimizer = spec.init(model)
    step = make_mae_step(cfg, model, optimizer, rows=rows)
    generator = torch.Generator(device=dev).manual_seed(seed)
    outdir = _pretrain_outdir(c)
    outdir.mkdir(parents=True, exist_ok=True)

    start_epoch = 1
    resume = c.get("resume")
    if resume == "auto":
        last = outdir / "last.npz"
        resume = str(last) if last.exists() else None
    if resume:
        _, extra = load_training_state(resume, model, optimizer)
        start_epoch = int(extra.get("epoch", 0)) + 1
        generator.manual_seed(seed + start_epoch)  # a fresh mask stream
        log.info(f"MAE resumed from {resume} at epoch {start_epoch}")

    it = iter(loader)
    for epoch in range(start_epoch, epochs + 1):
        losses = []
        t0 = time.time()
        for _ in range(epoch_length):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(loader)
                batch = next(it)
            losses.append(step(torch.from_numpy(batch["wav"]).to(dev), generator))
        log.info(f"MAE epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                 f"({epoch_length / (time.time() - t0):.1f} it/s)")
        if rank == 0:  # the only writer
            save_checkpoint(outdir / "mae_pretrained.npz", model, enc,
                            named_params=find_ema_params(optimizer),
                            extra={"epoch": epoch, "mae": True})
            save_training_state(outdir / "last.npz", model, optimizer, enc,
                                extra={"epoch": epoch})
    return outdir / "mae_pretrained.npz"
