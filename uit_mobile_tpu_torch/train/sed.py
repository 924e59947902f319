"""SED (sound event detection) trainer, counterpart of
``uit_mobile_tpu/train/sed.py``: strong-label framewise training.

    StrongFramewiseHDF5Dataset (random window + per-segment targets)
        -> forward_train_framewise ((B, tg, C) probabilities, BN updates)
        -> BCE over segments, backward, clip, optimizer update
        -> per-epoch segment-F1 validation on index-pure windows,
           best_sed.npz (the best micro F1) and the resumable last.npz

Config keys: ``model`` (a 'dm' head; ``pooling`` defaults to 'dm'),
``strong_train_data`` / ``strong_eval_data`` (TSVs with filename labels
hdf5path from to, one event interval per row), ``chunk_length`` (s,
default 1.0), ``min_overlap`` (0.5), ``threshold`` (0.5), batch_size,
epochs, epoch_length, optimizer(+args, default AdamW), warmup_iters,
use_scheduler, max_grad_norm, ema_decay, grad_accum, wavtransforms
(time-preserving only), spectransforms, data_dtype, frontend_precision,
seed, resume, auto_resume, multihost. ``multihost:`` scales the loop over
processes as the weak trainer does (train/loop.py): a global batch_size,
per-rank windows from a rank-offset seed, the global batch's step on every
rank, the same validation everywhere, rank 0 the only writer. The mean
over the segment axis is the clip-level dm output, so the checkpoint
serves and evaluates like any weak one.
"""

from __future__ import annotations

import random as _random
from pathlib import Path

import numpy as np
import torch

from .. import models
from ..augment import parse_spectransforms, parse_wavtransforms
from ..ckpt.io import load_training_state, save_checkpoint, save_training_state
from ..data import DataLoader, StrongFramewiseHDF5Dataset, read_tsv_data
from ..evaluate.metrics import segment_f1
from ..ops.mel import make_frontend_fn
from ..utils import add_file_sink, get_logger, resolve_device, validate_frontend_precision
from ..parallel import multihost
from ..parallel.mesh import dp_placement
from ..parallel.rows import Rows
from .loop import _json_safe_config, _make_outputdir, start_multihost, with_ema
from .schedule import cosine_with_warmup
from .steps import build_optimizer, find_ema_params, make_framewise_train_step, wrap_optimizer

log = get_logger()


def segment_geometry(cfg):
    """(n_segments, seg_seconds) of the dm head over one training window."""
    return cfg.grid_size[1], cfg.patch_stride * cfg.frontend.hop_length / cfg.frontend.sample_rate


def train_sed_from_config(config: dict, device="cuda", train_dataset=None,
                          eval_dataset=None) -> Path:
    """SED training on ``device`` -> the path of best_sed.npz. The datasets
    default to StrongFramewiseHDF5Dataset over the config's manifests;
    ``train_dataset``/``eval_dataset`` replace them (any map-style dataset
    of (wav, (n_segments, C) target, name), the eval one with index-pure
    windows). ``auto_resume: N`` restarts a crashed run up to N times from
    its last.npz in the same output directory."""
    start_multihost(config, device)
    retries = int(config.get("auto_resume") or 0)
    if not retries:
        return _train_sed_once(config, device, train_dataset, eval_dataset)
    config = dict(config)
    config["outputdir"] = str(_make_outputdir(config))
    for attempt in range(retries + 1):
        try:
            return _train_sed_once(config, device, train_dataset, eval_dataset)
        except Exception:
            last = Path(config["outputdir"]) / "last.npz"
            if attempt >= retries or not last.exists():
                raise
            log.exception(f"SED training crashed (attempt {attempt + 1}/{retries + 1}); "
                          f"auto-resuming from {last}")
            config["resume"] = str(last)
    raise AssertionError("unreachable")


def _check_config(c: dict, have_datasets: bool) -> None:
    """Refuse a bad config before any side effect."""
    validate_frontend_precision(c)
    if not have_datasets and not c.get("strong_train_data"):
        raise ValueError("SED training needs strong_train_data: a TSV of filename labels "
                         "hdf5path from to (one event interval per row)")
    if c.get("wavtransforms"):
        from ..augment.wav import TIME_PRESERVING_WAV_TRANSFORMS

        offending = set(c["wavtransforms"]) - TIME_PRESERVING_WAV_TRANSFORMS
        if offending:
            raise ValueError(
                f"SED training only admits time-preserving wavtransforms "
                f"({sorted(TIME_PRESERVING_WAV_TRANSFORMS)}); remove {sorted(offending)} — "
                f"they would move audio away from the fixed per-segment targets")


def _train_sed_once(c: dict, device, train_dataset, eval_dataset) -> Path:
    _check_config(c, train_dataset is not None)
    dev = resolve_device(device)
    outputdir = _make_outputdir(c)
    rank = multihost.process_index()
    logfile = Path(c.get("logfile", "train.log"))
    if rank > 0:
        logfile = logfile.with_name(f"{logfile.stem}.rank{rank}{logfile.suffix}")
    handler = add_file_sink(log, outputdir / logfile)
    try:
        return _train_sed_body(c, outputdir, dev, train_dataset, eval_dataset)
    finally:
        log.removeHandler(handler)
        handler.close()


def _make_dataset(c: dict, cfg, tsv, deterministic: bool, seed: int):
    df = read_tsv_data(tsv, basename=c.get("basename", True))
    if not ("from" in df.columns and "to" in df.columns):
        raise ValueError(f"{tsv}: SED manifests need from/to event-interval columns")
    n_seg, seg_s = segment_geometry(cfg)
    return StrongFramewiseHDF5Dataset(
        df, num_classes=cfg.outputdim, n_segments=n_seg, seg_seconds=seg_s,
        chunk_length=c.get("chunk_length", 1.0), min_overlap=c.get("min_overlap", 0.5),
        rng=_random.Random(seed * 1000), dtype=c.get("data_dtype", "float32"),
        deterministic=deterministic)


def _train_sed_body(c: dict, outputdir: Path, dev, train_ds, eval_ds) -> Path:
    log.info(f"SED training -> {outputdir}")
    for k, v in sorted(c.items()):
        log.info(f"{k} : {v}")
    model_args = dict(c.get("model_args", {}))
    model_args.setdefault("pooling", "dm")
    cfg = models.get_model_config(c["model"], outputdim=c.get("num_classes", 527), **model_args)
    if getattr(cfg, "pooling", None) != "dm":
        raise ValueError("SED training requires the 'dm' head")
    model = models.build(cfg, torch.Generator().manual_seed(c.get("seed", 42)), device=dev)
    n_seg, seg_s = segment_geometry(cfg)
    log.info(f"segment geometry: {n_seg} x {seg_s:.3f}s per {c.get('chunk_length', 1.0)}s "
             f"window")

    # every rank runs this control flow; rank-offset seeds draw other windows
    rank, n_proc = multihost.process_index(), multihost.process_count()
    is_main = rank == 0
    seed = c.get("seed", 42)
    data_seed = seed + rank * 7919
    if multihost.is_initialized():
        log.info(f"multi-host: process {rank}/{n_proc}")
    if train_ds is None:
        train_ds = _make_dataset(c, cfg, c["strong_train_data"], deterministic=False,
                                 seed=data_seed)
    if eval_ds is None:
        eval_ds = _make_dataset(c, cfg, c.get("strong_eval_data", c.get("strong_train_data")),
                                deterministic=True, seed=seed)
    num_workers = c.get("num_workers", 2)
    bs = c["batch_size"]
    if bs % n_proc:
        raise ValueError(f"multi-host SED training needs batch_size ({bs}) divisible by "
                         f"the process count ({n_proc})")
    mesh, _, _ = dp_placement([bs], device=dev)
    rows = None
    if mesh is not None:
        log.info(f"data-parallel over {mesh.size} devices")
        rows = Rows([bs // n_proc], dev)
    bs //= n_proc
    train_loader = DataLoader(train_ds, batch_size=bs, shuffle=True, drop_last=True,
                              num_workers=num_workers, seed=data_seed)
    if len(train_loader) == 0:
        raise ValueError(f"the SED training set has only {len(train_ds)} clips — fewer than "
                         f"batch_size={bs} (drop_last leaves no batches)")
    eval_loader = DataLoader(eval_ds, batch_size=c.get("eval_batch_size", c["batch_size"]),
                             shuffle=False,
                             num_workers=num_workers)

    epochs = c["epochs"]
    epoch_length = c.get("epoch_length") or len(train_loader)
    opt_args = dict(c.get("optimizer_args", {}))
    lr = opt_args.pop("lr", 1e-3)
    grad_accum = int(c.get("grad_accum", 1))
    schedule = (cosine_with_warmup(lr, max(1, epochs * epoch_length // grad_accum),
                                   c.get("warmup_iters", 1000))
                if c.get("use_scheduler", True) else lr)
    spec = wrap_optimizer(build_optimizer(c.get("optimizer", "AdamW"), schedule, **opt_args),
                          ema_decay=c.get("ema_decay"), grad_accum=grad_accum)
    optimizer = spec.init(model)
    frontend = make_frontend_fn(cfg.frontend, precision=validate_frontend_precision(c))
    step = make_framewise_train_step(
        cfg, model, optimizer, loss_name=c.get("loss", "BCELoss"),
        loss_args=c.get("loss_args"), max_grad_norm=c.get("max_grad_norm"),
        wav_augment=parse_wavtransforms(c.get("wavtransforms")),
        spec_augment=parse_spectransforms(c.get("spectransforms")), frontend_fn=frontend,
        rows=rows)
    generator = torch.Generator(device=dev).manual_seed(seed)

    def validate(eval_model) -> dict:
        probs, targets = [], []
        for batch in eval_loader:
            wav = torch.from_numpy(batch["wav"]).to(dev)
            pr, _ = models.apply_framewise(cfg, eval_model, wav, frontend_fn=frontend)
            if tuple(pr.shape) != batch["target"].shape:
                raise ValueError(f"segment grid mismatch: model {tuple(pr.shape)} vs targets "
                                 f"{batch['target'].shape} — chunk_length and target_length "
                                 f"must describe the same window")
            probs.append(pr)
            targets.append(batch["target"])
        probs = torch.cat(probs).cpu().numpy().reshape(-1, cfg.outputdim)
        return segment_f1(probs, np.concatenate(targets).reshape(-1, cfg.outputdim),
                          threshold=c.get("threshold", 0.5))

    best, start_epoch = -1.0, 1
    resume = c.get("resume")
    if resume == "auto":
        last = outputdir / "last.npz"
        resume = str(last) if last.exists() else None
    if resume:
        _, extra = load_training_state(resume, model, optimizer)
        start_epoch = int(extra.get("epoch", 0)) + 1
        best = float(extra.get("best", -1.0))
        generator.manual_seed(seed + start_epoch)  # a fresh augment stream
        log.info(f"SED resumed from {resume} at epoch {start_epoch} (best segF1 {best:.4f})")
    best_path = outputdir / "best_sed.npz"
    it = iter(train_loader)
    for epoch in range(start_epoch, epochs + 1):
        losses = []
        for _ in range(epoch_length):
            try:
                batch = next(it)
            except StopIteration:
                it = iter(train_loader)
                batch = next(it)
            m = step({"wav": torch.from_numpy(batch["wav"]).to(dev),
                      "target": torch.from_numpy(batch["target"]).to(dev)}, generator)
            losses.append(m["total_loss"])
        ema = find_ema_params(optimizer)
        scores = validate(with_ema(model, ema))
        log.info(f"Epoch {epoch}: loss {torch.stack(losses).mean().item():.4f} "
                 f"segF1 micro {scores['Segment_Micro_F1']:.4f} "
                 f"macro {scores['Segment_Macro_F1']:.4f}")
        # the same scores on every rank, so the same decisions; rank 0 writes
        if scores["Segment_Micro_F1"] > best:
            best = scores["Segment_Micro_F1"]
            if is_main:
                save_checkpoint(best_path, model, cfg, named_params=ema,
                                extra={"segment_f1_micro": best, "epoch": epoch,
                                       "run_config": _json_safe_config(c)})
        if is_main:
            save_training_state(outputdir / "last.npz", model, optimizer, cfg,
                                extra={"epoch": epoch, "best": best})
    log.info(f"Best segment-F1 micro {best:.4f} -> {best_path}")
    return best_path

