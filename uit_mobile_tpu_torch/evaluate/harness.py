"""Evaluation harness, counterpart of ``uit_mobile_tpu/evaluate/harness.py``.

The Evaluator resolves a checkpoint (file, experiment directory, local
pretrained name or comma-joined ensemble; ``cli.common.resolve_model``),
streams an eval manifest through the batched forward of
``ops.pipeline.make_forward_fn`` on the card (the long-clip crop path
engages inside the model), gathers (probs, targets) on the host and
computes the metric suites:

- ``audioset``: the reference's 11 metrics on the 527 AudioSet classes,
  plus mAPKWS when the manifest has keyword positives;
- ``gsc``: the Accuracy@threshold protocol (metrics.gsc_accuracy), with
  its sweep and per-keyword operating metrics;
- ``calibrate``: temperature scaling fit on a held-out manifest;
- ``strong``: segment and event scores of framewise probabilities against
  event intervals, with threshold sweeps and PSDS;
- ``test_sample``: the top-k of one wav, padded by the reference's rule.

Reports go to ``evaluation_<target>.txt``. Every clip is read through
``_clips``, the one method that turns a manifest into clips.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional

import numpy as np
import torch

from ..data import DataLoader, WeakHDF5Dataset, events_by_file, read_tsv_data, to_device
from ..utils import get_logger
from ..utils.device import resolve_device
from .metrics import compute_metrics, gsc_accuracy

log = get_logger()

AUDIOSET_METRICS = [
    "Precision", "Recall", "Macro_Precision", "Macro_Recall", "Macro_F1",
    "Micro_Precision", "Micro_Recall", "Micro_F1", "AP",
    "PositiveMultiClass_Accuracy", "mAP",
]
DEFAULT_SWEEP = (0.05, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9)


class Evaluator:
    def __init__(self, model_spec: Optional[str] = None, batch_size: int = 32,
                 num_workers: int = 3, use_kernel: Optional[bool] = None,
                 report_dir: Optional[str] = None,
                 bucket_seconds: Optional[float] = None,
                 fast: bool = False, data_parallel: bool = False,
                 dtype: str = "float32", scan_batches: int = 1,
                 dispatch_depth: int = 4, device="cuda"):
        """device: where the model runs ('cuda' by default; raises without
        a GPU unless 'cpu' is asked for).
        use_kernel: None = the fused mel kernel whenever the model is on
        CUDA; True on the CPU runs the kernel's plain version.
        bucket_seconds: right-pad every batch to the next multiple of this
        many seconds (a handful of shapes instead of one per batch-max
        length; padding perturbs crop windows slightly, so leave None for
        parity with the reference's batch-max padding).
        fast: the 3-pass bf16 DFT and the transposed layout (probabilities
        within 1e-3 of exact; keep False for parity gates).
        data_parallel: True shards every batch over a mesh of the visible
        devices of ``device`` (a ``parallel.Mesh`` names its devices, which
        may repeat); with one device it is the single-device path, as in
        JAX. Batches zero-pad to a multiple of the mesh; fast takes the
        per-sample clamp (as JAX does), exact keeps the batch-global clamp,
        whose max the shards reduce together; both keep the frontend of
        the single-device path (the kernel on the card); scan_batches is
        ignored.
        dtype: 'int16' moves batches as raw PCM (half the bytes; the
        frontends fold the 1/32768 scale in exactly, so results are
        bitwise float32's).
        scan_batches: K>1 runs K consecutive same-shape batches as one
        (K, B, T) block through ops.pipeline.make_scanned_forward; shape
        changes and the epoch tail go batch by batch, so loader order and
        coverage are kept and results equal the per-batch run.
        dispatch_depth: up to this many batch outputs stay on the device
        before the oldest is copied to the host (the copy is the sync
        point); results are bitwise identical at any depth."""
        if dtype not in ("float32", "int16"):
            raise ValueError(f"dtype must be 'float32' or 'int16', got {dtype!r}")
        if scan_batches < 1 or dispatch_depth < 1:
            raise ValueError(f"scan_batches ({scan_batches}) and dispatch_depth "
                             f"({dispatch_depth}) must be >= 1")
        self.device = resolve_device(device)
        self.mesh = None
        if data_parallel:
            from ..parallel.mesh import Mesh, make_mesh

            self.mesh = (data_parallel if isinstance(data_parallel, Mesh)
                         else make_mesh(devices=self.device))
            self.device = self.mesh.devices[0]
        self._resolved = None
        self._resolved_spec = None
        self._run_config: dict = {}
        self._model_spec = model_spec
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.use_kernel = use_kernel
        self.report_dir = report_dir
        self._user_report_dir = report_dir is not None
        self.bucket_seconds = bucket_seconds
        self.fast = fast
        self.dtype = dtype
        self.scan_batches = scan_batches
        self.dispatch_depth = dispatch_depth

    # ------------------------------------------------------------------ setup

    def _setup(self, model_spec=None):
        """-> (cfg, model or list of models) on the Evaluator's device."""
        spec = model_spec or self._model_spec
        if spec is None and self._resolved is not None:
            return self._resolved
        if spec is None:
            raise ValueError("no model specified")
        if self._resolved is None or spec != self._resolved_spec:
            from ..cli.common import resolve_model

            cfg, model, extra = resolve_model(spec, device=self.device, return_extra=True)
            self._run_config = (extra or {}).get("run_config") or {}
            if not self._user_report_dir:
                p = Path(spec)
                self.report_dir = str(p if p.is_dir() else (p.parent if p.exists() else "."))
            self._resolved = (cfg, model)
            self._resolved_spec = spec
            self._make_forward(cfg, model)
        return self._resolved

    def _kernel(self) -> bool:
        return self.device.type == "cuda" if self.use_kernel is None else self.use_kernel

    def _make_forward(self, cfg, model):
        """Per-batch forward (and K-batch forward with scan_batches > 1) on
        host arrays -> probs left on the device (no sync)."""
        from ..ops.pipeline import make_forward_fn, make_scanned_forward

        if self.mesh is not None and self.mesh.size > 1:
            return self._make_dp_forward(cfg, model)
        # exact keeps the canonical bft orientation for parity gates; the
        # transposed routes engage only in fast mode
        self._fwd_fn = make_forward_fn(cfg, model, use_kernel=self._kernel(),
                                       precision="fast" if self.fast else "exact",
                                       btf=self.fast)
        scanned = make_scanned_forward(self._fwd_fn) if self.scan_batches > 1 else None
        self._fwd_async = lambda wav_np: self._fwd_fn(to_device(wav_np, self.device))
        self._fwd_block = (None if scanned is None else
                           lambda block_np: scanned(to_device(block_np, self.device))
                           .flatten(0, 1))

    def _make_dp_forward(self, cfg, model):
        """JAX's routing (``uit_mobile_tpu/evaluate/harness.py:128-168``):
        fast takes the per-sample clamp; exact keeps the batch-global clamp,
        whose max the shards reduce together; batches pad to a mesh
        multiple; no K-batch blocks. Unlike JAX, exact keeps the kernel: the
        shards run as one collective (``data_parallel_forward``), so the
        kernel's clamp is global too."""
        from ..ops.pipeline import make_forward_fn
        from ..parallel.mesh import data_parallel_forward, replicate_tree

        kernel = self._kernel()
        top_db_mode = "per_sample" if kernel and self.fast else None
        fns = [make_forward_fn(cfg, m, use_kernel=kernel,
                               precision="fast" if self.fast else "exact", btf=self.fast,
                               top_db_mode=top_db_mode)
               for m in replicate_tree(self.mesh, model)]
        dp = data_parallel_forward(fns, self.mesh)
        n = self.mesh.size

        def fwd_async(wav_np: np.ndarray):
            b = wav_np.shape[0]
            if b % n:
                wav_np = np.concatenate(
                    [wav_np, np.zeros((n - b % n, wav_np.shape[1]), wav_np.dtype)])
            return dp(torch.from_numpy(np.ascontiguousarray(wav_np)))[:b]

        self._fwd_fn = dp
        self._fwd_async, self._fwd_block = fwd_async, None
        self.scan_batches = 1

    def _fwd(self, wav_np: np.ndarray) -> np.ndarray:
        return self._fwd_async(wav_np).cpu().numpy()

    # ------------------------------------------------------------------ data

    def _clips(self, eval_data, num_classes: int, basename: bool = True,
               strong: bool = False):
        """The one place clips come from. Weak: a dataset, index ->
        (wave, multihot target, filename), over the manifest rows. Strong:
        an iterable of (filename, wave, [(class, onset_s, offset_s), ...])
        per clip, read one at a time. Waves are float32 or raw int16 PCM
        (``dtype``)."""
        df = read_tsv_data(eval_data, basename=basename)
        if not strong:
            return WeakHDF5Dataset(df, num_classes=num_classes, dtype=self.dtype)
        if "from" not in df.columns or "to" not in df.columns:
            raise ValueError(f"{eval_data}: strong eval needs from/to event-interval columns")
        reader = WeakHDF5Dataset(df.drop_duplicates(subset=["hdf5path", "filename"]),
                                 num_classes=num_classes, dtype=self.dtype)
        return ((fname, reader._read(h5, fname), events)
                for fname, h5, events in events_by_file(df))

    # -------------------------------------------------------------- inference

    @staticmethod
    def _pad_wav_to_target(cfg, wav):
        """The reference's eval pad rule (evaluate.py:253-260): pad the
        waveform until the mel reaches target_length-1 frames, with the
        fractional frame count and the int() truncation kept."""
        t_len = cfg.target_length - 1
        n_frames = wav.shape[-1] / cfg.frontend.hop_length
        if n_frames < t_len:
            diff = int((t_len - n_frames) * cfg.frontend.hop_length)
            wav = np.pad(wav, ((0, 0), (0, diff)))
        return wav

    def _run_epoch(self, dataset, pad_to_target: bool = False):
        """-> (preds (N, C), targets (N, C), filenames), in dataset order."""
        cfg, _ = self._setup()
        loader = DataLoader(dataset, batch_size=self.batch_size, shuffle=False,
                            num_workers=self.num_workers)
        preds, targets, names = [], [], []
        scan_k = self.scan_batches
        buf: list = []  # batches awaiting a full K-batch block
        inflight: list = []  # indices into preds still on the device

        def push(dev_pred):
            preds.append(dev_pred)
            inflight.append(len(preds) - 1)
            while len(inflight) > self.dispatch_depth:
                i = inflight.pop(0)
                preds[i] = preds[i].cpu().numpy()

        def flush_buf():
            # full blocks run as one K-batch call; short tails (shape change,
            # epoch end) run batch by batch
            if len(buf) == scan_k > 1:
                push(self._fwd_block(np.stack([b["wav"] for b in buf])))
            else:
                for b in buf:
                    push(self._fwd_async(b["wav"]))
            for b in buf:
                targets.append(b["target"])
                names.extend(b["filenames"])
            buf.clear()

        for batch in loader:
            wav = batch["wav"]
            if pad_to_target and hasattr(cfg, "target_length"):
                wav = self._pad_wav_to_target(cfg, wav)
            if self.bucket_seconds:
                step = int(self.bucket_seconds * cfg.frontend.sample_rate)
                target_len = -(-wav.shape[-1] // step) * step
                wav = np.pad(wav, ((0, 0), (0, target_len - wav.shape[-1])))
            batch = dict(batch, wav=wav)
            if buf and buf[0]["wav"].shape != wav.shape:
                flush_buf()
            buf.append(batch)
            if len(buf) == scan_k:
                flush_buf()
        flush_buf()
        if not preds:
            raise ValueError(
                f"evaluation produced zero batches from {len(dataset)} manifest rows — "
                f"check the manifest path and the basename setting (a basename mismatch "
                f"between manifest filenames and HDF5 keys filters every row; gsc() reads "
                f"it from the checkpoint's run_config)")
        preds = [p if isinstance(p, np.ndarray) else p.cpu().numpy() for p in preds]
        return np.concatenate(preds), np.concatenate(targets), names

    @staticmethod
    def _dump_predictions(path, names, preds: np.ndarray, targets: np.ndarray):
        """Per-clip probabilities, targets and filenames to one .npz, rows
        in manifest order."""
        np.savez_compressed(path, preds=preds.astype(np.float32),
                            targets=targets.astype(np.float32),
                            filenames=np.asarray(names, dtype=object))
        log.info(f"wrote predictions ({preds.shape[0]} clips x {preds.shape[1]} classes) "
                 f"to {path}")

    # ------------------------------------------------------------------ modes

    def audioset(self, experiment_path: Optional[str] = None,
                 audioset_eval_data: str = "datasets/audioset/data/labels/eval.csv",
                 label_csv: Optional[str] = None,
                 dump_predictions: Optional[str] = None):
        cfg, _ = self._setup(experiment_path)
        # targets at the head's width (>= 527); the headline metrics stay
        # the 527-column AudioSet slice, mAPKWS added for keyword positives
        num_classes = max(527, getattr(cfg, "outputdim", 527))
        preds, targets, names = self._run_epoch(self._clips(audioset_eval_data, num_classes))
        if dump_predictions is not None:
            self._dump_predictions(dump_predictions, names, preds, targets)
        results = compute_metrics(AUDIOSET_METRICS, preds[:, :527], targets[:, :527])
        if num_classes > 527 and targets[:, 527:].any():
            results.update(compute_metrics(["mAPKWS"], preds, targets))
        if label_csv is None:
            from ..cli.common import LABEL_CSV

            label_csv = LABEL_CSV if LABEL_CSV.exists() else None
        self._write_report("Audioset", results, label_csv)
        return results

    def calibrate(self, experiment_path: Optional[str] = None,
                  eval_data: str = "datasets/audioset/data/labels/eval.csv",
                  num_classes: Optional[int] = None, per_class: bool = False,
                  n_bins: int = 15, out=None):
        """Fit temperature scaling on a held-out manifest (one epoch) and
        report ECE and BCE before and after; ``per_class`` fits a (C,)
        vector (classes without positives keep T=1); ``out`` writes the
        calibration JSON. ``num_classes`` defaults to the head width."""
        from .calibration import apply_temperature, ece, fit_temperature, save_calibration

        cfg, _ = self._setup(experiment_path)
        if num_classes is None:
            num_classes = getattr(cfg, "outputdim", 537)
        preds, targets, _ = self._run_epoch(self._clips(eval_data, num_classes))
        T = fit_temperature(preds, targets, per_class=per_class)
        cal = apply_temperature(preds, T)
        before = compute_metrics(["BCELoss"], preds, targets)["BCELoss"]
        after = compute_metrics(["BCELoss"], cal, targets)["BCELoss"]
        results = {
            "temperature": (float(T) if np.ndim(T) == 0
                            else {i: float(t) for i, t in enumerate(T) if t != 1.0}),
            "ECE_before": ece(preds, targets, n_bins=n_bins),
            "ECE_after": ece(cal, targets, n_bins=n_bins),
            "BCE_before": before,
            "BCE_after": after,
            "n_clips": int(preds.shape[0]),
        }
        if out is not None:
            save_calibration(out, T, meta={
                "eval_data": str(eval_data), "n_clips": int(preds.shape[0]),
                "per_class": bool(per_class), "ece_before": results["ECE_before"],
                "ece_after": results["ECE_after"]})
        return results

    def gsc(self, experiment_path: Optional[str] = None,
            eval_data: str = "datasets/gsc/data/labels/test_gsc_aslabels.tsv",
            threshold: float = 0.2, pad: bool = False, detailed: bool = False,
            sweep: bool = False, tie_mode: str = "first",
            dump_predictions: Optional[str] = None):
        return self._kws(experiment_path, eval_data, threshold=threshold, label_name="GSC",
                         pad=pad, detailed=detailed, sweep=sweep, tie_mode=tie_mode,
                         dump_predictions=dump_predictions)

    def _kws(self, experiment_path, eval_data, threshold: float = 0.2,
             label_name: str = "GSC", pad: bool = False, detailed: bool = False,
             sweep: bool = False, tie_mode: str = "first",
             dump_predictions: Optional[str] = None):
        cfg, _ = self._setup(experiment_path)
        # the training config decides whether manifests index by basename
        # (reference evaluate.py:200-201); a checkpoint without one -> False
        dataset = self._clips(eval_data, getattr(cfg, "outputdim", 537),
                              basename=self._run_config.get("basename", False))
        preds, targets, names = self._run_epoch(dataset, pad_to_target=pad)
        if dump_predictions is not None:
            self._dump_predictions(dump_predictions, names, preds, targets)
        results = {f"Accuracy@{threshold}": gsc_accuracy(preds, targets, threshold=threshold,
                                                         tie_mode=tie_mode)}
        if sweep:
            from .metrics import kws_threshold_sweep

            curve = kws_threshold_sweep(preds, targets, tie_mode=tie_mode)
            for t, row in curve.items():
                log.info(f"threshold {t:.2f}: "
                         + "  ".join(f"{k} {v * 100:.2f}" for k, v in row.items()))
            results["_sweep"] = curve
        if detailed:
            from .metrics import kws_operating_metrics

            op = kws_operating_metrics(preds, targets, threshold=threshold)
            results.update({k: v for k, v in op.items() if not isinstance(v, dict)})
            results["_detail"] = {k: v for k, v in op.items() if isinstance(v, dict)}
        self._write_report(label_name,
                           {k: v for k, v in results.items() if not k.startswith("_")}, None)
        return results

    def strong(self, experiment_path: Optional[str] = None,
               eval_data: str = "datasets/strong/eval.tsv",
               threshold=0.5, min_overlap: float = 0.5,
               median_kernel: int = 1, event_collar: float = 0.2,
               offset_collar_rate: float = 0.2, min_duration: float = 0.0,
               merge_gap: float = 0.0, dump_events: Optional[str] = None,
               criterion: str = "collar", dtc: float = 0.5, gtc: float = 0.5,
               cttc: Optional[float] = None, sweep=None, psds=None,
               thresholds_out: Optional[str] = None):
        """Strong-label (SED) evaluation of framewise probabilities over
        full clips against event intervals: segment F1/precision/recall
        and event F1, each clip's probabilities median-filtered
        (``median_kernel`` segments), thresholded, merged into events
        (``merge_gap``, ``min_duration``) and matched to the references with
        an onset collar of ``event_collar`` s (offset collar max(collar,
        offset_collar_rate * duration)) or, with criterion='intersection',
        the DTC/GTC rule.

        eval_data: TSV with filename/labels/hdf5path/from/to, one event
        interval per row. Clips are zero-padded to whole seconds (padded
        segments count as negatives) and scored with per-sample dB
        clamping, so no clip's scores depend on the others in its batch.

        threshold: scalar, (C,) vector or {class: th} mapping
        (events.per_class_thresholds), for events and segments alike.
        sweep: thresholds at which events and segments are scored again
        from the same probabilities (one model pass), returned under
        ``_event_operating_curve`` with the best thresholds overall and per
        class. psds: truthy (or a dict of alpha_st/alpha_ct/e_max) also
        scores PSDS over the sweep with the intersection criterion; implies
        the default sweep. thresholds_out: write the per-class best
        thresholds (events.save_thresholds); implies the default sweep.
        dump_events: write every predicted event as a TSV.

        State stays O(classes): each clip's segment counts and events are
        folded into count vectors and per-threshold scorers as its batch
        finishes, never a probability cache over the whole set."""
        from ..ops.pipeline import make_framewise_fn
        from .events import EventScorer, extract_events, per_class_thresholds
        from .metrics import segment_counts, segment_events_to_targets, \
            segment_scores_from_counts

        cfg, model = self._setup(experiment_path)
        num_classes = getattr(cfg, "outputdim", 537)
        sr = cfg.frontend.sample_rate
        if thresholds_out is not None and sweep is None and not psds:
            sweep = DEFAULT_SWEEP
        if not np.isscalar(threshold):
            threshold = per_class_thresholds(threshold, num_classes)
        clips = self._clips(eval_data, num_classes,
                            basename=self._run_config.get("basename", False), strong=True)
        # framewise probabilities on the device; segment times float64 on
        # the host; per-sample dB clamping decouples co-batched clips
        fwd = make_framewise_fn(cfg, model, use_kernel=self._kernel(),
                                top_db_mode="per_sample")

        def mk_scorer(ct: bool = False):
            return EventScorer(t_collar=event_collar, offset_collar_rate=offset_collar_rate,
                               criterion=criterion, dtc=dtc, gtc=gtc, cttc=cttc,
                               count_cross_triggers=ct)

        scorer = mk_scorer()
        if psds and sweep is None:
            sweep = DEFAULT_SWEEP
        seg_tp, seg_fp, seg_fn = (np.zeros(num_classes, np.int64) for _ in range(3))
        # cross-trigger counting scans preds x other classes' refs: only
        # when alpha_ct uses it
        want_ct = isinstance(psds, dict) and bool(psds.get("alpha_ct"))
        # PSDS needs the intersection criterion: reuse the sweep scorer
        # when it is one
        reuse = bool(psds) and criterion == "intersection"
        sweep_ths = sorted(float(t) for t in sweep) if sweep is not None else []
        sweep_sc, sweep_sc_int, sweep_seg = {}, {}, {}
        for th in sweep_ths:
            sweep_sc[th] = mk_scorer(ct=reuse and want_ct)
            sweep_sc_int[th] = sweep_sc[th] if reuse else (
                EventScorer(criterion="intersection", dtc=dtc, gtc=gtc, cttc=cttc,
                            count_cross_triggers=want_ct) if psds else None)
            sweep_seg[th] = np.zeros(3, np.int64)
        pred_rows: list = []
        total_samples = 0

        def flush(items):
            batch = np.stack([w for w, _, _ in items])
            if batch.shape[0] < self.batch_size:
                # partial groups pad to the full batch with silence: one
                # batch shape per clip length; per-sample clamping keeps the
                # padded rows out of the real clips' scores
                batch = np.concatenate([batch, np.zeros(
                    (self.batch_size - batch.shape[0],) + batch.shape[1:], batch.dtype)])
            probs_dev, times = fwd(to_device(batch, self.device))
            probs = probs_dev.cpu().numpy()[: len(items)]
            for p, (_, events, fname) in zip(probs, items):
                tgt = segment_events_to_targets(times, events, num_classes,
                                                min_overlap=min_overlap)
                for acc, cnt in zip((seg_tp, seg_fp, seg_fn),
                                    segment_counts(p, tgt, threshold=threshold)):
                    acc += cnt
                pred = extract_events(times, p, threshold=threshold,
                                      median_kernel=median_kernel,
                                      min_duration=min_duration, merge_gap=merge_gap)
                scorer.add_clip(pred, events)
                for th in sweep_ths:
                    pred_th = extract_events(times, p, threshold=th,
                                             median_kernel=median_kernel,
                                             min_duration=min_duration, merge_gap=merge_gap)
                    sweep_sc[th].add_clip(pred_th, events)
                    sc_int = sweep_sc_int[th]
                    if sc_int is not None and sc_int is not sweep_sc[th]:
                        sc_int.add_clip(pred_th, events)
                    sweep_seg[th] += [c.sum() for c in segment_counts(p, tgt, threshold=th)]
                if dump_events is not None:
                    pred_rows.extend((fname, c, on, off) for c, on, off in pred)

        # clips of one padded length batch together (at most batch_size
        # clips buffered per length)
        pending: dict = {}
        for fname, wav, events in clips:
            total_samples += int(wav.shape[-1])
            pad_to = -(-wav.shape[-1] // sr) * sr
            wav = np.pad(wav, (0, pad_to - wav.shape[-1]))
            pending.setdefault(pad_to, []).append((wav, events, fname))
            if len(pending[pad_to]) >= self.batch_size:
                flush(pending.pop(pad_to))
        for items in pending.values():
            flush(items)
        results = segment_scores_from_counts(seg_tp, seg_fp, seg_fn)
        results.update(scorer.scores())
        if sweep is not None:
            results.update(self._sweep_results(sweep_ths, sweep_sc, sweep_seg,
                                               thresholds_out))
            if psds:
                from .psds import psds as psds_score

                opts = dict(psds) if isinstance(psds, dict) else {}
                points, ct_points, ref_dur = [], [], {}
                for th in sweep_ths:
                    sc_int = sweep_sc_int[th]
                    cls = set(sc_int.tp) | set(sc_int.fp) | set(sc_int.fn)
                    points.append({c: (sc_int.tp[c], sc_int.fp[c], sc_int.fn[c]) for c in cls})
                    ct_points.append(dict(sc_int.ct))
                    ref_dur = {c: s / 3600.0 for c, s in sc_int.ref_duration.items()}
                if opts.get("alpha_ct"):
                    opts.update(ct_points=ct_points, ref_duration_hours=ref_dur)
                else:
                    opts.pop("alpha_ct", None)
                results.update(psds_score(points, duration_hours=total_samples / sr / 3600.0,
                                          **opts))
        if dump_events is not None:
            import pandas as pd

            pd.DataFrame(pred_rows, columns=["filename", "event", "onset", "offset"]).to_csv(
                dump_events, sep="\t", index=False)
        self._write_report("Strong",
                           {k: v for k, v in results.items() if not k.startswith("_")}, None)
        return results

    @staticmethod
    def _sweep_results(sweep_ths, sweep_sc, sweep_seg, thresholds_out) -> dict:
        """The operating curve of a strong sweep, the best thresholds
        overall and per class, and the micro F1 with every class at its own
        best threshold (written to ``thresholds_out`` if given)."""
        from .events import EventScorer, save_thresholds

        curve, per_class_curves = {}, {}
        for th in sweep_ths:
            scores = sweep_sc[th].scores()
            for c, f in scores.get("_event_per_class_f1", {}).items():
                per_class_curves.setdefault(c, {})[th] = f
            row = {k: v for k, v in scores.items() if not k.startswith("_")}
            s_tp, s_fp, s_fn = sweep_seg[th]
            row["Segment_Micro_F1"] = EventScorer._prf(s_tp, s_fp, s_fn)[2]
            curve[th] = row
        out = {"_event_operating_curve": curve}
        if not curve:
            return out
        out["_best_event_threshold"] = max(curve, key=lambda t: curve[t]["Event_Micro_F1"])
        out["_best_segment_threshold"] = max(curve, key=lambda t: curve[t]["Segment_Micro_F1"])
        out["_best_event_threshold_per_class"] = {
            c: max(ths, key=ths.get) for c, ths in sorted(per_class_curves.items())}
        # every class at its own best sweep threshold (unseen classes at the
        # global best): extract_events and EventScorer treat classes
        # independently, so the sweep scorers' per-class counts at those
        # thresholds are exactly the tuned point's
        tuned = out["_best_event_threshold_per_class"]
        default_th = out["_best_event_threshold"]
        classes: set = set()
        for sc in sweep_sc.values():
            classes |= set(sc.tp) | set(sc.fp) | set(sc.fn)
        t_tp = t_fp = t_fn = 0
        for c in classes:
            sc_c = sweep_sc[float(tuned.get(c, default_th))]
            t_tp, t_fp, t_fn = t_tp + sc_c.tp[c], t_fp + sc_c.fp[c], t_fn + sc_c.fn[c]
        out["Event_Micro_F1_per_class_tuned"] = EventScorer._prf(t_tp, t_fp, t_fn)[2]
        if thresholds_out is not None:
            save_thresholds(thresholds_out, tuned, default=default_th)
        return out

    def test_sample(self, experiment_path: Optional[str], sample: str, topk: int = 5):
        from ..data import read_wav

        cfg, _ = self._setup(experiment_path)
        wav, sr = read_wav(sample)
        if sr != cfg.frontend.sample_rate:
            raise ValueError(f"{sample}: {sr} Hz, the model expects "
                             f"{cfg.frontend.sample_rate} Hz")
        pred = self._fwd(self._pad_wav_to_target(cfg, wav[:1]))[0]
        top = np.argsort(pred)[::-1][:topk]
        for idx in top:
            print(f"[{idx:=3}] : {pred[idx] * 100:.2f}")
        return {int(i): float(pred[i]) for i in top}

    # ----------------------------------------------------------------- report

    def _write_report(self, target: str, results: dict, label_csv, scale=100.0):
        label_maps = None
        if label_csv:
            from ..cli.common import load_label_map

            label_maps = load_label_map(label_csv)
        lines = [f"{target} Results"]
        for metric, value in results.items():
            if isinstance(value, np.ndarray):
                lm = label_maps or {i: i for i in range(len(value))}
                for cl in np.argsort(value)[::-1]:
                    lines.append(f"{metric} Class {lm[int(cl)]} : {value[cl] * scale:<4.2f}")
            else:
                lines.append(f"{metric} : {value * scale:<4.2f}")
        report = "\n".join(lines)
        out = Path(self.report_dir or ".") / f"evaluation_{target}.txt"
        try:
            out.write_text(report + "\n")
        except OSError:
            pass
        log.info(report)
