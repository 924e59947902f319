"""Training loop, counterpart of ``uit_mobile_tpu/train/loop.py`` (single
host, one device).

``Trainer(config, device).train()``: the student (``model:`` +
``model_args:``), the frozen PSL teacher (``psl:``), AudioSet + KWS loaders
zipped into one stream, the fused train step (train/steps.py), validation
every ``valid_every`` epochs on the eval forward, the top ``n_saved``
checkpoints ``best_model_<step>_mAP=<score>.npz``, early stopping after
``early_stop`` evaluations without gain, the resumable ``last.npz``, and at
the end ``averaged.npz``, the mean of the kept checkpoints, in the JAX
package's npz format. Both the student and the teacher take the fused mel
kernel through ``ops.mel.make_frontend_fn`` (on a CUDA device the kernel
launches; a CPU device takes its plain version): the student in its
``mel_layout`` at ``frontend_precision``, the teacher through
``'tfb_to_bft'``. ``psl: {mode: offline, cache: ...}`` loads no teacher:
the AudioSet dataset draws grid crops whose targets come from a PSL cache
(data/psl_cache.py) and the step is the plain one. ``pretrained:``
retargets the positional embeddings to the student's grid before its
shape-filtered load.

Multi-process (``multihost:``, one rank a card): every rank runs this same
control flow. Config batch sizes are global; each rank loads its share
with a rank-offset data seed and the step computes the global batch's
update on every rank (``parallel.rows``); every rank validates the same
data and takes the same decisions; rank 0 alone writes checkpoints,
``last.npz`` and ``averaged.npz``, and every other rank logs to
``train.rank<r>.log``.
"""

from __future__ import annotations

import copy
import dataclasses
import datetime
import json
import os
import random as _random
import time
import uuid
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .. import models
from ..augment import parse_spectransforms, parse_wavtransforms
from ..ckpt.convert import module_from_numpy
from ..ckpt.io import (average_checkpoints, load_pretrained_partial, load_training_state,
                       retarget_pos_embeds, save_checkpoint, save_numpy_checkpoint,
                       save_training_state)
from ..data import (BalancedSampler, DataLoader, MultiDataLoader, WeakHDF5Dataset,
                    WeakRandomCropHDF5Dataset, device_prefetch, read_tsv_data)
from ..evaluate.metrics import compute_metrics
from ..ops.mel import launches as mel_launches
from ..ops.mel import make_frontend_fn
from ..parallel import multihost
from ..parallel.mesh import dp_placement
from ..parallel.rows import Rows
from ..utils import add_file_sink, get_logger, resolve_device, validate_frontend_precision
from .schedule import cosine_with_warmup
from .steps import (build_optimizer, find_ema_params, make_eval_step, make_train_step,
                    wrap_optimizer)

log = get_logger()


def _make_outputdir(config: dict) -> Path:
    if config.get("outputdir"):  # an explicit pin (auto-resume restarts land here)
        outputdir = Path(config["outputdir"])
    else:
        outputdir = (Path(config["outputpath"]) / config.get("config_stem", "run")
                     / str(config["model"])
                     / f"{datetime.datetime.now().strftime('%Y-%m-%d_%H-%M')}_{uuid.uuid1().hex}")
    outputdir.mkdir(exist_ok=True, parents=True)
    return outputdir


def _json_safe_config(c: dict) -> dict:
    """The part of the run config that survives the checkpoint's JSON blob."""
    import json

    out = {}
    for k, v in c.items():
        try:
            json.dumps(v)
        except (TypeError, ValueError):
            continue
        out[k] = v
    return out


def with_ema(model, ema: Optional[dict]):
    """The model validation scores: ``model``, or a copy of it with the EMA
    parameters (name -> tensor)."""
    if ema is None:
        return model
    m = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in m.named_parameters():
            p.copy_(ema[name])
    return m.eval()


class Trainer:
    """One training run on ``device`` ("cuda" unless the caller asks for
    "cpu"; no GPU raises). ``setup()`` builds the model, teacher, loaders,
    optimizer and steps; ``train()`` runs them."""

    def __init__(self, config: dict, device="cuda"):
        self.config = config
        self.run_config = _json_safe_config(config)
        validate_frontend_precision(config)  # before any side effect
        self.device = resolve_device(device)
        # multihost.initialize has run already (train_from_config does it)
        self.rank, self.n_proc = multihost.process_index(), multihost.process_count()
        self.is_main = self.rank == 0
        self.outputdir = _make_outputdir(config)
        logfile = Path(config.get("logfile", "train.log"))
        if self.rank > 0:  # per-rank logs, not interleaved on a shared filesystem
            logfile = logfile.with_name(f"{logfile.stem}.rank{self.rank}{logfile.suffix}")
        self._file_handler = add_file_sink(log, self.outputdir / logfile)
        log.info(f"Storing output in {self.outputdir}")
        log.info(f"device: {self.device}"
                 + (f" ({torch.cuda.get_device_name(self.device)})"
                    if self.device.type == "cuda" else ""))
        if multihost.is_initialized():
            log.info(f"multi-host: process {self.rank}/{self.n_proc}")
        for k, v in sorted(config.items()):
            log.info(f"{k} : {v}")

    # ---------------------------------------------------------------- setup

    def _build_model(self):
        c = self.config
        cfg = models.get_model_config(c["model"], outputdim=c.get("num_classes", 527),
                                      **c.get("model_args", {}))
        model = models.build(cfg, torch.Generator().manual_seed(c.get("seed", 42)),
                             device=self.device)
        pretrained = c.get("pretrained")
        if pretrained:
            from ..cli.common import resolve_params

            log.info(f"initializing from pretrained {pretrained}")
            # e.g. MAE pretraining at target_length 1012 -> fine-tuning at 102
            p_params = retarget_pos_embeds(resolve_params(pretrained)[1], model)
            n = load_pretrained_partial(model, p_params)
            log.info(f"Loading {n} parameter tensors")
        return cfg, model

    def _load_psl(self):
        """The frozen distillation teacher -> (cfg, model), or (None, None)
        without PSL and in offline mode (the targets come from the cache)."""
        psl = self.config.get("psl")
        if psl is None:
            return None, None
        if psl.get("mode") == "offline":
            if not psl.get("cache"):
                raise ValueError("psl: {mode: offline} needs cache: <psl_cache.h5> (one file, "
                                 "a shard glob, or a list — build with cli.psl_cache "
                                 "[--shard i/N])")
            from ..data.psl_cache import resolve_cache_paths

            caches = resolve_cache_paths(psl["cache"])  # raises on missing/empty
            log.info(f"offline PSL: cached teacher targets from "
                     f"{caches if len(caches) > 1 else caches[0]} (teacher-free train step)")
            return None, None
        from ..cli.common import resolve_model

        spec = psl.get("pretrained")
        log.info(f"Using PSL model {psl['model']} from {spec}")
        try:
            cfg, model = resolve_model(spec, device=self.device)
        except (FileNotFoundError, NotImplementedError, ValueError):
            if not psl.get("allow_untrained", False):
                raise
            log.warning(f"PSL teacher {spec} not loadable; allow_untrained: the teacher "
                        f"is {psl['model']} at its random init")
            cfg = models.get_model_config(psl["model"], outputdim=psl.get("outputdim", 527))
            model = models.build(cfg, torch.Generator().manual_seed(0), device=self.device)
        if psl.get("compute_dtype") and hasattr(cfg, "compute_dtype"):
            cfg = dataclasses.replace(cfg, compute_dtype=psl["compute_dtype"])
        model.eval().requires_grad_(False)
        return cfg, model

    def _build_data(self):
        """-> (train loader: an infinite stream of {'audioset', 'kws'}
        batches, test loader)."""
        c = self.config
        num_classes = c.get("num_classes", 527)
        chunk_length = c.get("chunk_length")
        use_crop = c.get("psl") is not None or chunk_length is not None
        data_dtype = c.get("data_dtype", "float32")
        ds_counter = iter(range(1000))
        # rank-offset seeds: each rank draws other samples (rank 0 draws the
        # single process's); validation reads alike on every rank
        data_seed = c.get("seed", 42) + self.rank * 7919
        psl = c.get("psl") or {}
        psl_cache = psl.get("cache") if psl.get("mode") == "offline" else None

        def make_ds(df, psl_cache=None):
            rng = _random.Random(data_seed * 1000 + next(ds_counter))
            if psl_cache is not None:
                if "from" in df.columns and "to" in df.columns:
                    raise ValueError("psl: {mode: offline} expects a weak (filename/labels/"
                                     "hdf5path) audioset manifest — strong interval "
                                     "manifests have no cached-crop grid")
                from ..data import PSLCachedRandomCropHDF5Dataset

                return PSLCachedRandomCropHDF5Dataset(
                    df, chunk_length=chunk_length or 1.0, num_classes=num_classes,
                    cache_path=psl_cache, rng=rng, dtype=data_dtype)
            if "from" in df.columns and "to" in df.columns:
                from ..data import WeakChunkedHDF5Dataset

                return WeakChunkedHDF5Dataset(df, num_classes=num_classes,
                                              fixed_length=chunk_length or 1.0, rng=rng,
                                              dtype=data_dtype)
            if use_crop:
                return WeakRandomCropHDF5Dataset(df, chunk_length=chunk_length or 1.0,
                                                 num_classes=num_classes, rng=rng,
                                                 dtype=data_dtype)
            return WeakHDF5Dataset(df, num_classes=num_classes, dtype=data_dtype)

        basename = c.get("basename", True)

        def read_as(path):
            # AudioSet manifests are basenamed, except strong (from/to) ones
            import pandas as pd

            cols = pd.read_csv(path, sep=r"\s+", nrows=0).columns
            return read_tsv_data(path, basename=basename if ("from" in cols and "to" in cols)
                                 else True)

        as_train, as_eval = read_as(c["audioset_train_data"]), read_as(c["audioset_eval_data"])
        kws_train = read_tsv_data(c["kws_train_data"], basename=basename)
        kws_eval = read_tsv_data(c["kws_test_data"], basename=basename)
        log.info(f"#Lengths: Audioset Train - {len(as_train)} Audioset Eval - {len(as_eval)} "
                 f"KWS Train - {len(kws_train)} KWS Eval - {len(kws_eval)}")
        kws_bs, as_bs = self._half_batches()
        num_workers = c.get("num_workers", 2)
        if self.n_proc > 1 and not use_crop:
            # full-clip batches pad to their own max length: the ranks' steps
            # would differ in shape and hang in their collectives
            raise ValueError(
                "multi-host training needs fixed-length batches — set chunk_length "
                "(random-crop pipeline); full-clip variable-length batches would give "
                "each host a different global batch shape")

        def loader(df, which, bs, psl_cache=None):
            sampler = (BalancedSampler(df["labels"], random_state=data_seed)
                       if c.get(which) == "balanced" else None)
            return DataLoader(make_ds(df, psl_cache), batch_size=bs, num_workers=num_workers,
                              sampler=sampler, shuffle=True, drop_last=True, seed=data_seed)

        train_loader = MultiDataLoader(
            kws=loader(kws_train, "kws_sampler", kws_bs),
            audioset=loader(as_train, "as_sampler", as_bs, psl_cache))
        import pandas as pd

        test_loader = DataLoader(WeakHDF5Dataset(pd.concat((as_eval, kws_eval)),
                                                 num_classes=num_classes),
                                 batch_size=c.get("eval_batch_size", c["batch_size"]),
                                 num_workers=num_workers, shuffle=False)
        return train_loader, test_loader

    def _half_batches(self) -> tuple[int, int]:
        """This rank's (kws, audioset) rows a step: the config's global
        sizes over the process count, which must divide them."""
        c = self.config
        halves = {"kws_batch_size": c.get("kws_batch_size", c["batch_size"] // 2),
                  "as_batch_size": c.get("as_batch_size", c["batch_size"] // 2)}
        for name, bs in halves.items():
            if bs % self.n_proc:
                raise ValueError(f"multi-host training needs {name} ({bs}) divisible by "
                                 f"the process count ({self.n_proc})")
        return halves["kws_batch_size"] // self.n_proc, halves["as_batch_size"] // self.n_proc

    def setup(self) -> None:
        """Build everything the run needs (attributes below) on the device."""
        c = self.config
        fe_prec = validate_frontend_precision(c)
        self.cfg, self.model = self._build_model()
        self.psl_cfg, self.psl_model = self._load_psl()
        self.train_loader, self.test_loader = self._build_data()
        self.epoch_length = c.get("epoch_length") or len(self.train_loader)
        total_steps = c["epochs"] * self.epoch_length
        opt_args = dict(c.get("optimizer_args", {}))
        lr = opt_args.pop("lr", 1e-3)
        # grad_accum: K loader micro-batches per applied update; the
        # schedule counts applied updates, so the cosine still ends the run
        grad_accum = int(c.get("grad_accum", 1))
        schedule = (cosine_with_warmup(lr, max(1, total_steps // grad_accum),
                                       c.get("warmup_iters", 1000))
                    if c.get("use_scheduler", True) else lr)
        spec = wrap_optimizer(build_optimizer(c.get("optimizer", "Adam"), schedule, **opt_args),
                              ema_decay=c.get("ema_decay"), grad_accum=grad_accum)
        self.optimizer = spec.init(self.model)
        if spec.ema_decay is not None:
            log.info(f"parameter EMA (decay {spec.ema_decay}): validation and checkpoints "
                     f"use the smoothed weights")
        mel_layout = getattr(self.cfg, "mel_layout", "bft")
        self.frontend = make_frontend_fn(self.cfg.frontend, precision=fe_prec, layout=mel_layout)
        self.psl_frontend = (make_frontend_fn(self.psl_cfg.frontend, precision=fe_prec,
                                              layout="tfb_to_bft")
                             if self.psl_cfg is not None else None)
        psl = c.get("psl") or {}
        # the data-parallel mesh over the ranks (each PSL half shards alone)
        kws_bs, as_bs = self._half_batches()
        halves = [kws_bs * self.n_proc, as_bs * self.n_proc]
        mesh, _, _ = dp_placement(halves if self.psl_cfg is not None else [sum(halves)],
                                  device=self.device)
        self.rows = None
        if mesh is not None:
            log.info(f"data-parallel over {mesh.size} devices")
            self.rows = Rows([as_bs, kws_bs] if self.psl_cfg is not None else [as_bs + kws_bs],
                             self.device)
        if int(c.get("steps_per_dispatch", 1)) > 1 and self.n_proc > 1:
            raise ValueError(
                "steps_per_dispatch > 1 is a single-host dispatch-amortization lever (the "
                "host-side K-batch stacking is not wired for process-local global arrays); "
                "drop it from multi-host configs")
        self.train_step = make_train_step(
            self.cfg, self.model, self.optimizer,
            loss_name=c.get("loss", "BCELoss"), loss_args=c.get("loss_args") or {},
            mixup_alpha=c.get("mixup"), max_grad_norm=c.get("max_grad_norm"),
            psl_cfg=self.psl_cfg, psl_model=self.psl_model,
            # offline mode loads no teacher: the step is the plain one
            distill_mode="psl" if psl.get("mode") == "offline" else psl.get("mode", "psl"),
            distill_alpha=psl.get("alpha", 1.0),
            distill_classes=psl.get("classes", 527),
            psl_split=as_bs,
            wav_augment=parse_wavtransforms(c.get("wavtransforms", {})),
            spec_augment=parse_spectransforms(c.get("spectransforms", {}), layout=mel_layout),
            frontend_fn=self.frontend, psl_frontend_fn=self.psl_frontend, rows=self.rows)
        self.eval_step = make_eval_step(self.cfg, frontend_fn=self.frontend)
        self.generator = torch.Generator(device=self.device).manual_seed(c.get("seed", 42))

    @staticmethod
    def to_step_batch(batch: dict) -> dict:
        """A loader batch -> the step's flat numpy batch: PSL halves stacked
        [audioset, kws] on the host, each right-padded to a common length."""
        if "wav" in batch:
            return {"wav": batch["wav"], "target": batch["target"]}
        aw, kw = batch["audioset"]["wav"], batch["kws"]["wav"]
        T = max(aw.shape[-1], kw.shape[-1])
        aw = np.pad(aw, ((0, 0), (0, T - aw.shape[-1])))
        kw = np.pad(kw, ((0, 0), (0, T - kw.shape[-1])))
        return {"wav": np.concatenate([aw, kw]),
                "target": np.concatenate([batch["audioset"]["target"], batch["kws"]["target"]])}

    # ---------------------------------------------------------------- train

    def train(self) -> Path:
        try:
            return self._train()
        finally:
            log.removeHandler(self._file_handler)
            self._file_handler.close()

    def _train(self) -> Path:
        c = self.config
        self.setup()
        model, opt, cfg = self.model, self.optimizer, self.cfg
        epochs = c["epochs"]
        start_epoch = 1
        resume = c.get("resume")
        if resume == "auto":
            last = self.outputdir / "last.npz"
            resume = str(last) if last.exists() else None
        extra: dict = {}
        if resume:
            _, extra = load_training_state(resume, model, opt)
            start_epoch = int(extra.get("epoch", 0)) + 1
            log.info(f"resumed from {resume} at epoch {start_epoch}")
        best_score = float(extra.get("best_score", -np.inf))
        bad_evals = int(extra.get("bad_evals", 0))
        step_count = int(extra.get("step", 0))
        saved = sorted(((float(s), Path(p)) for s, p in extra.get("saved", [])
                        if Path(p).exists()), key=lambda x: -x[0])
        patience, n_saved = c.get("early_stop", 10), c.get("n_saved", 4)
        sf = c.get("score_function") or ["mAP", 1.0]
        if isinstance(sf, str):
            sf = [sf, 1.0]
        if not (isinstance(sf, (list, tuple)) and len(sf) == 2 and isinstance(sf[0], str)):
            raise ValueError(f"score_function must be a metric name or [name, sign], got {sf!r}")
        score_name, score_sign = sf[0], float(sf[1])

        # 'steps_per_dispatch' is accepted and runs as single steps: stacking
        # K batches saves no launch in eager mode (it will once a CUDA graph
        # of the step exists)
        train_iter = device_prefetch((self.to_step_batch(b) for b in self.train_loader),
                                     self.device, size=2)
        stop = False
        try:
            for epoch in range(start_epoch, epochs + 1):
                if stop:
                    break
                t0 = time.time()
                losses = [self.train_step(next(train_iter), self.generator)["total_loss"]
                          for _ in range(self.epoch_length)]
                step_count += self.epoch_length
                mean_loss = torch.stack(losses).mean().item()  # one sync per epoch
                log.info(f"Epoch {epoch:<4} loss {mean_loss:.4f} "
                         f"({self.epoch_length / (time.time() - t0):.1f} it/s)")
                if epoch % c.get("valid_every", 1) == 0:
                    # the same scores and decisions on every rank; rank 0 writes
                    ema = find_ema_params(opt)
                    score = score_sign * self._validate(self._eval_model(ema), epoch, score_name)
                    ckpt_path = self.outputdir / f"best_model_{step_count}_mAP={score:.4f}.npz"
                    saved.append((score, ckpt_path))
                    saved.sort(key=lambda x: -x[0])
                    if (score, ckpt_path) in saved[:n_saved] and self.is_main:
                        save_checkpoint(ckpt_path, model, cfg, named_params=ema,
                                        extra={"step": step_count, "mAP": score,
                                               "run_config": self.run_config})
                    if self.is_main:
                        for _, p in saved[n_saved:]:
                            p.unlink(missing_ok=True)
                    saved = saved[:n_saved]
                    if score > best_score:
                        best_score, bad_evals = score, 0
                    else:
                        bad_evals += 1
                        if bad_evals >= patience:
                            log.info(f"Early stopping at epoch {epoch}")
                            stop = True
                    if self.is_main:
                        save_training_state(  # lossless mid-training resume point
                            self.outputdir / "last.npz", model, opt, cfg,
                            extra={"epoch": epoch, "step": step_count, score_name: score,
                                   "best_score": best_score, "bad_evals": bad_evals,
                                   "saved": [[s, str(p)] for s, p in saved]})
                self._fault_drill(epoch)
        finally:
            train_iter.close()

        # rank 0 holds the checkpoints and makes the deliverable; the other
        # ranks' work is in those weights (every update was the global batch's)
        if c.get("average", True) and saved:
            output_model = self.outputdir / "averaged.npz"
            if self.is_main:
                log.info("Averaging best models ...")
                avg_p, avg_s, avg_cfg, _ = average_checkpoints([p for _, p in saved])
                save_numpy_checkpoint(output_model, avg_p, avg_s, avg_cfg,
                                      extra={"averaged_from": [str(p) for _, p in saved],
                                             "run_config": self.run_config})
                final = module_from_numpy(avg_cfg, avg_p, avg_s, device=self.device)
                log.info(f"Averaged model {score_name}: "
                         f"{self._validate(final, 'avg', score_name):.4f}")
        elif saved:
            output_model = saved[0][1]
        else:
            output_model = self.outputdir / "final.npz"
            if self.is_main:
                save_checkpoint(output_model, model, cfg, named_params=find_ema_params(opt),
                                extra={"step": step_count, "run_config": self.run_config})
        # which kernels this process's run went through
        log.info(f"mel kernel launches: {json.dumps(mel_launches)}")
        log.info(f"Results can be found at {self.outputdir}")
        log.info(f"Final model is at {output_model}")
        return output_model

    def _fault_drill(self, epoch: int) -> None:
        """The restart machinery's chaos drill: ``UIT_FAULT_EPOCH`` crashes
        rank ``UIT_FAULT_RANK`` (default 0) after that epoch; off on a
        resumed run, so that the relaunched ranks survive it."""
        fault_epoch = os.environ.get("UIT_FAULT_EPOCH")
        if (fault_epoch is not None and epoch == int(fault_epoch)
                and self.rank == int(os.environ.get("UIT_FAULT_RANK", "0"))
                and not self.config.get("resume")):
            raise RuntimeError(f"injected fault after epoch {epoch} "
                               f"(UIT_FAULT_EPOCH={fault_epoch}, rank {self.rank})")

    def _eval_model(self, ema: Optional[dict]):
        return with_ema(self.model, ema)

    def _validate(self, model, epoch, metric: str = "mAP") -> float:
        """Score the test loader; each batch right-pads to the next multiple
        of ``valid_bucket_seconds`` (default 1 s; None = the batch max).
        The predictions reach the host once, at the end."""
        bucket_seconds = self.config.get("valid_bucket_seconds", 1.0)
        sr = self.config.get("sample_rate", 16000)
        preds, targets = [], []
        for batch in self.test_loader:
            wav = batch["wav"]
            if bucket_seconds:
                step = int(bucket_seconds * sr)
                wav = np.pad(wav, ((0, 0), (0, -(-wav.shape[-1] // step) * step - wav.shape[-1])))
            preds.append(self.eval_step(model, torch.from_numpy(wav).to(self.device)))
            targets.append(batch["target"])
        y_pred = torch.cat(preds).cpu().numpy()
        y_true = np.concatenate(targets)
        names = [metric] + (["mAP"] if metric != "mAP" else [])
        if y_pred.shape[1] > 527:
            names += ["mAPAudioset", "mAPKWS"]
        m = compute_metrics(names, y_pred, y_true)
        log.info(f"Validation Results - Epoch : {epoch:<4} "
                 + " ".join(f"{k} {v:<5.4f}" for k, v in m.items()))
        return float(m[metric])


def start_multihost(config: dict, device) -> None:
    """Join the process group a ``multihost:`` key asks for, before a
    trainer builds anything; refuse the per-process ``auto_resume`` there."""
    if not config.get("multihost"):
        return
    multihost.initialize_from_config(config["multihost"], device=device)
    if multihost.process_count() > 1 and config.get("auto_resume"):
        raise ValueError(
            "auto_resume is single-host (a per-process retry would desynchronize the "
            "collective program across ranks); use a COORDINATED whole-pod restarter that "
            "relaunches ALL hosts with resume: auto — uit_mobile_tpu_torch.cli.launch "
            "--auto-resume N does exactly this locally")


def train_from_config(config: dict, device="cuda") -> Path:
    """Build a Trainer and run it. ``multihost: true`` (a launcher's
    environment) or ``{coordinator_address, num_processes, process_id}``
    joins the process group first. ``auto_resume: N``: on a crash (anything
    but KeyboardInterrupt) restart up to N times from ``last.npz`` in the
    same output directory (one process only)."""
    start_multihost(config, device)
    retries = int(config.get("auto_resume") or 0)
    if not retries:
        return Trainer(config, device).train()
    config = dict(config)
    trainer = Trainer(config, device)
    config["outputdir"] = str(trainer.outputdir)
    for attempt in range(retries + 1):
        try:
            return trainer.train()
        except Exception:
            last = Path(config["outputdir"]) / "last.npz"
            if attempt >= retries or not last.exists():
                raise
            log.exception(f"training crashed (attempt {attempt + 1}/{retries + 1}); "
                          f"auto-resuming from {last}")
            config["resume"] = str(last)
            trainer = Trainer(config, device)
    raise AssertionError("unreachable")
