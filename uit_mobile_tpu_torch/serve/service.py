"""Batching inference service, counterpart of ``uit_mobile_tpu/serve/service.py``.

- Callers submit waveforms of up to ``max_seconds`` and get a Future. A
  batcher thread drains the queue, groups requests into LENGTH BUCKETS
  (whole seconds), right-zero-pads each request to its bucket and each
  batch to the bucket's FIXED batch size (``batch_size // seconds``), so the
  kernels see a small closed set of shapes.
- The batcher only ENQUEUES the work: on CUDA it copies the batch to the
  card and enqueues the forward on a stream the service owns, records a
  CUDA event, and hands (result, event) to a completer thread, which waits
  on the event before copying the probabilities back and resolving the
  Futures. Host batching overlaps device compute; in-flight batches are
  bounded by ``max_inflight`` (backpressure on the batcher).
- Isolation: the frontend defaults to ``top_db_mode='per_sample'``, so
  co-batched requests do not couple through a batch-global dB clamp.
- On the card the forward is ``make_forward_fn(precision='fast')``: the
  fused mel kernel in the 'tfb' layout (transposed kernel for batches of
  at least 128, row kernel below).
- Calibration (temperature scaling from ``cli.evaluate calibrate -o``) is
  applied on the host in the completer, on the small (B, C) block of
  probabilities; it belongs to the deployment and survives ``reload()``.
"""

from __future__ import annotations

import copy
import dataclasses
import numbers
import os
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional, Sequence

import numpy as np
import torch

from ..evaluate.calibration import apply_temperature, load_calibration
from ..frontend import normalize_pcm16, quantize_pcm16
from ..ops.pipeline import make_forward_fn, make_scanned_forward
from ..utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    batch_size: int = 256          # slots per 1s-bucket batch
    max_seconds: int = 10          # longest accepted clip
    max_wait_ms: float = 5.0       # batching window before a partial batch runs
    sample_rate: int = 16000
    use_kernel: Optional[bool] = None  # None: the fused kernel on CUDA
    warmup: bool = True            # run every bucket once at startup
    max_inflight: int = 8          # bound on enqueued-but-unresolved batches
    # 'per_sample' (default): each clip clamps against its own max.
    # 'torch': torchaudio's batch-global clamp, for offline-eval parity.
    top_db_mode: str = "per_sample"
    # True: every batch shards over a mesh of the visible devices of the
    # service's device (a parallel.Mesh names them; they may repeat). One
    # device is the single-device path. The batch sizes round up to a mesh
    # multiple; the 'torch' clamp's max is reduced over the shards;
    # scan_batches is ignored.
    data_parallel: object = False
    # 'float32' or 'int16': with 'int16' batches cross to the card as raw
    # PCM (half the bytes); the kernel folds the 1/32768 scale in exactly
    dtype: str = "float32"
    # when a bucket has >= scan_batches full batches pending, they are
    # enqueued together as one K-batch call (1 disables)
    scan_batches: int = 1

    @classmethod
    def low_latency(cls, **overrides) -> "ServiceConfig":
        """Single-clip-latency preset: a small batch bucket, no batching
        window, scan folding off, int16 transfer."""
        base = dict(batch_size=8, max_wait_ms=0.0, scan_batches=1, dtype="int16")
        base.update(overrides)
        return cls(**base)


def resolve_calibration(calibration):
    """Temperature scaling as a deployment gives it -> None, a float or a
    (C,) float64 vector: a scalar, a (C,) vector, or the path of the JSON
    that ``cli.evaluate calibrate -o`` writes."""
    if calibration is None:
        return None
    if isinstance(calibration, (str, os.PathLike)):
        calibration = load_calibration(calibration)
    if isinstance(calibration, numbers.Real):
        return float(calibration)
    return np.asarray(calibration, np.float64)


class TaggingService:
    """Batched async tagging: submit((T,) wav) -> Future[(C,) probs].

    ``model`` is copied onto ``device`` (default ``"cuda"``; raises without
    a GPU unless ``device="cpu"`` is asked for). ``calibration``: see
    ``resolve_calibration``; every result is ``apply_temperature``d."""

    def __init__(self, model_cfg, model, config: ServiceConfig = ServiceConfig(), *,
                 device="cuda", calibration=None, _start_worker: bool = True,
                 _forward_fn=None, _fixed_samples: Optional[int] = None):
        if config.dtype not in ("float32", "int16"):
            raise ValueError(f"dtype must be 'float32' or 'int16', got {config.dtype!r}")
        self.device = resolve_device(device)
        self.cfg = config
        self.calibration = resolve_calibration(calibration)
        self._np_dtype = np.int16 if config.dtype == "int16" else np.float32
        self._model_cfg = model_cfg
        # sealed program injected by from_artifact: no layout/frontend policy
        # to apply, and no hot reload (the program is the weights)
        self._sealed_fwd = _forward_fn
        self._mesh = None
        if config.data_parallel and _forward_fn is None:
            from ..parallel.mesh import Mesh, make_mesh

            mesh = (config.data_parallel if isinstance(config.data_parallel, Mesh)
                    else make_mesh(devices=self.device))
            if mesh.size > 1:
                self._mesh, self.device = mesh, mesh.devices[0]
        batch_multiple = 1 if self._mesh is None else self._mesh.size
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._scan_k = max(1, config.scan_batches) if self._mesh is None else 1
        self._fwd, self._scanned_fwd = self._build_forwards(model)
        self.weights_version = 1
        self._reload_lock = threading.Lock()
        self._q: queue.Queue = queue.Queue()
        # (result, event, chunk) awaiting materialization; bounded ->
        # backpressure on the batcher when the device falls behind
        self._done_q: queue.Queue = queue.Queue(maxsize=max(1, config.max_inflight))
        self._closed = False
        self._close_lock = threading.Lock()
        sr = config.sample_rate
        if _fixed_samples is not None:
            # artifact serving: one bucket at the artifact's clip length
            # (its time dim is part of the exported program)
            self._buckets = [(_fixed_samples, config.batch_size)]
        else:
            # every bucket's batch a multiple of the mesh
            self._buckets = [(s * sr, -(-max(1, config.batch_size // s) // batch_multiple)
                              * batch_multiple) for s in range(1, config.max_seconds + 1)]
        if config.warmup:
            self._warmup(self._fwd, self._scanned_fwd)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._completer = threading.Thread(target=self._complete, daemon=True)
        if _start_worker:
            self._start()

    @classmethod
    def from_artifact(cls, path, config: ServiceConfig = ServiceConfig(), *,
                      device="cuda", calibration=None):
        """Serve a ``.uitx`` artifact (ckpt/artifact.py): the exported
        program is the whole model, so no model code, weights or config
        are needed. The artifact must be batch-polymorphic (the
        ``export_serving`` default) on a whole-second clip length, and its
        input dtype must match ``config.dtype``. One length bucket (the
        artifact's clip length); shorter clips right-zero-pad to it.
        ``data_parallel``/``scan_batches`` are rejected: the artifact is a
        sealed single-device program. ``artifact_meta`` holds its
        metadata (the label map among it)."""
        from ..ckpt.artifact import load_artifact

        fn, meta = load_artifact(path, device=device)
        shape = meta["input_shape"]
        if shape[0] != "b":
            raise ValueError(
                f"artifact has fixed batch {shape[0]}: serving needs a batch-polymorphic "
                f"export (export_serving batch_size=None)")
        n_samples = int(shape[1])
        sr = config.sample_rate
        if n_samples % sr:
            raise ValueError(
                f"artifact clip length {n_samples} is not a whole second at {sr} Hz: "
                f"bucket padding cannot target it")
        if meta["input_dtype"] != config.dtype:
            raise ValueError(
                f"artifact input dtype {meta['input_dtype']} != service dtype {config.dtype}")
        if config.data_parallel:
            raise ValueError("data_parallel is unavailable for artifact serving (sealed "
                             "single-device program)")
        if config.scan_batches > 1:
            raise ValueError("scan_batches is unavailable for artifact serving (the "
                             "artifact is the whole program)")
        config = dataclasses.replace(config, max_seconds=n_samples // sr)
        service = cls(None, None, config, device=device, calibration=calibration,
                      _forward_fn=fn, _fixed_samples=n_samples)
        service.artifact_meta = meta
        return service

    def _build_forwards(self, model):
        """(per-batch fwd, K-batch fwd | None) under the service's policy,
        over the service's own copy of the model on its device."""
        if self._sealed_fwd is None:
            model = copy.deepcopy(model).to(self.device).eval()
        if self._stream is not None:
            # the weights were copied on this thread's stream; the service's
            # stream reads them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        if self._sealed_fwd is not None:
            return self._sealed_fwd, None
        use_kernel = self.cfg.use_kernel
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        if self._mesh is not None:
            from ..parallel.mesh import data_parallel_forward, replicate_tree

            return data_parallel_forward(
                [make_forward_fn(self._model_cfg, m, use_kernel=use_kernel,
                                 precision="fast" if use_kernel else "exact",
                                 top_db_mode=self.cfg.top_db_mode)
                 for m in replicate_tree(self._mesh, model)], self._mesh), None
        fwd = make_forward_fn(self._model_cfg, model, use_kernel=use_kernel,
                              precision="fast" if use_kernel else "exact",
                              top_db_mode=self.cfg.top_db_mode)
        scanned = make_scanned_forward(fwd) if self._scan_k > 1 else None
        return fwd, scanned

    def _enqueue(self, fn, host_batch: np.ndarray):
        """Copy a host batch to the device and enqueue ``fn`` on the
        service's stream -> (result tensor, CUDA event | None)."""
        x = torch.from_numpy(host_batch)
        if self._stream is None:
            return fn(x), None
        with torch.cuda.stream(self._stream):
            out = fn(x)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _warmup(self, fwd, scanned_fwd):
        """Run every bucket once (kernel build and first-launch costs are
        paid here, not by the first requests)."""
        for length, bs in self._buckets:
            _, ev = self._enqueue(fwd, np.zeros((bs, length), self._np_dtype))
            if scanned_fwd is not None:
                _, ev = self._enqueue(
                    scanned_fwd, np.zeros((self._scan_k, bs, length), self._np_dtype))
            if ev is not None:
                ev.synchronize()

    def reload(self, model, model_cfg=None) -> int:
        """Hot-swap the weights: build and warm the new forwards off the hot
        path, then swap them in. In-flight batches finish on the old
        weights. Returns the new weights version (starts at 1). An
        artifact-backed service raises: the sealed program is the weights;
        restart with the new artifact instead."""
        if self._sealed_fwd is not None:
            raise RuntimeError("artifact-backed service cannot hot-reload: the exported "
                               "program is the weights; restart with the new artifact")
        with self._reload_lock:
            if model_cfg is not None:
                self._model_cfg = model_cfg
            fwd, scanned = self._build_forwards(model)
            if self.cfg.warmup:
                self._warmup(fwd, scanned)
            self._fwd, self._scanned_fwd = fwd, scanned
            self.weights_version += 1
            return self.weights_version

    def _start(self):
        if not self._worker.is_alive():
            self._worker.start()
            self._completer.start()

    # ------------------------------------------------------------------- API

    def submit(self, wav: np.ndarray) -> Future:
        """Queue a single (T,) waveform; resolves to (C,) probs. Accepts
        normalized float32 or raw int16 PCM, converted to the service dtype."""
        wav = np.asarray(wav)
        if wav.ndim == 2 and wav.shape[0] == 1:
            wav = wav[0]  # (1, T) from data.read_wav
        if wav.ndim != 1:
            raise ValueError(
                f"submit takes one mono clip shaped (T,) or (1, T); got "
                f"{wav.shape} — downmix or split multichannel audio first")
        if wav.dtype != self._np_dtype:
            wav = (quantize_pcm16(wav) if self._np_dtype == np.int16
                   else normalize_pcm16(wav))
        if wav.shape[0] > self.cfg.max_seconds * self.cfg.sample_rate:
            raise ValueError(
                f"clip of {wav.shape[0]} samples exceeds max_seconds="
                f"{self.cfg.max_seconds}")
        fut: Future = Future()
        # closed-check and enqueue are atomic against close()'s sentinel
        with self._close_lock:
            if self._closed:
                raise RuntimeError("service is closed")
            self._q.put((wav, fut))
        return fut

    def infer_many(self, wavs: Sequence[np.ndarray]) -> list[np.ndarray]:
        futs = [self.submit(w) for w in wavs]
        return [f.result() for f in futs]

    def close(self):
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)  # FIFO: everything submitted before is ahead
        if self._worker.ident is not None:
            self._worker.join(timeout=60)
        if self._completer.ident is not None:
            self._completer.join(timeout=60)
        if self._worker.is_alive():
            return  # still draining: the queued requests are its to resolve
        while True:  # the worker is gone: cancel what can never be served
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is not None:
                item[1].cancel()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    # ---------------------------------------------------------------- worker

    def _bucket_of(self, n: int):
        for length, bs in self._buckets:
            if n <= length:
                return length, bs
        raise ValueError(f"clip of {n} samples fits no bucket")

    def _run(self):
        # the completer must always get its sentinel
        try:
            self._run_loop()
        finally:
            self._done_q.put(None)

    def _guarded_dispatch(self, pending):
        """A host-side failure fails THESE futures, not the worker thread."""
        try:
            self._dispatch(pending)
        except Exception as e:
            for _, fut in pending:
                if not fut.done():
                    fut.set_exception(e)

    def _run_loop(self):
        shutdown = False
        while not shutdown:
            item = self._q.get()
            if item is None:
                break
            pending = [item]
            # batching window: a hard deadline from the first request; beyond
            # one full batch, only requests already queued are taken
            limit = self.cfg.batch_size * self._scan_k
            deadline = time.monotonic() + self.cfg.max_wait_ms / 1e3
            while len(pending) < limit:
                if len(pending) < self.cfg.batch_size:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        nxt = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                else:
                    try:
                        nxt = self._q.get_nowait()
                    except queue.Empty:
                        break
                if nxt is None:
                    shutdown = True
                    break
                pending.append(nxt)
            self._guarded_dispatch(pending)
        # sentinel received: serve what was queued behind it
        leftovers = []
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                break
            if nxt is not None:
                leftovers.append(nxt)
        if leftovers:
            self._guarded_dispatch(leftovers)

    def _enqueue_chunk(self, fn, block: np.ndarray, chunk):
        try:
            out, event = self._enqueue(fn, block)
        except Exception as e:
            for _, fut in chunk:
                if not fut.done():
                    fut.set_exception(e)
            return
        self._done_q.put((out, event, chunk))

    def _dispatch(self, pending):
        """Group into buckets and enqueue device work; never waits on results
        (only on the in-flight bound)."""
        groups: dict[tuple[int, int], list] = {}
        for wav, fut in pending:
            try:
                key = self._bucket_of(wav.shape[0])
            except ValueError as e:
                if not fut.done():
                    fut.set_exception(e)
                continue
            groups.setdefault(key, []).append((wav, fut))
        for (length, bs), items in groups.items():
            i = 0
            K = self._scan_k
            while K > 1 and len(items) - i >= K * bs:  # sustained load
                chunk = items[i: i + K * bs]
                i += K * bs
                block = np.zeros((K, bs, length), dtype=self._np_dtype)
                for j, (wav, _) in enumerate(chunk):
                    block[j // bs, j % bs, : wav.shape[0]] = wav
                self._enqueue_chunk(self._scanned_fwd, block, chunk)
            for i in range(i, len(items), bs):
                chunk = items[i: i + bs]
                batch = np.zeros((bs, length), dtype=self._np_dtype)
                for j, (wav, _) in enumerate(chunk):
                    batch[j, : wav.shape[0]] = wav
                self._enqueue_chunk(self._fwd, batch, chunk)

    def _complete(self):
        """Wait for each batch's event in enqueue order and resolve its Futures."""
        while True:
            item = self._done_q.get()
            if item is None:
                return
            out, event, chunk = item
            try:
                if event is None:
                    probs = out.numpy()
                else:
                    event.synchronize()
                    with torch.cuda.stream(self._stream):
                        probs = out.cpu().numpy()
                probs = probs.reshape(-1, probs.shape[-1])  # (K, bs, C) -> rows
                if self.calibration is not None:
                    probs = apply_temperature(probs, self.calibration)
                for j, (_, fut) in enumerate(chunk):
                    if not fut.done():
                        fut.set_result(probs[j])
            except Exception as e:
                for _, fut in chunk:
                    if not fut.done():
                        fut.set_exception(e)
