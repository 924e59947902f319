"""Real-time sliding-window tagging over continuous audio streams,
counterpart of ``uit_mobile_tpu/serve/streaming.py``.

The UiT models have a 1-second receptive window, so always-on deployment
re-scores a sliding window every hop. S independent streams share one
fixed-shape batched forward of (S, window) samples; per-stream ring buffers
advance by ``hop_seconds`` and all due windows score in one batch.

Two paths, as in the JAX module:

- the host path (``feed``, ``_push``, ``_score``): the numpy ring is
  authoritative, and the due windows cross to the device whole, each in its
  stream's row of an (n_streams, window) batch, so the shape stays fixed;
- the steady state of ``feed_all``: the ring LIVES ON THE DEVICE, and each
  hop only the (S, hop) chunk crosses; the advanced ring is built as
  ``torch.cat([ring[:, hop:], chunk], 1)`` (a shift in place would be an
  overlapping copy). The host mirror goes stale and ``_sync_host`` rebuilds
  it on demand. Invariant: ``_dev_buf is None`` implies ``_host_stale`` is
  False (every path clearing the ring syncs first).

All device work of a tagger runs on one CUDA stream, the one current when it
was built, whichever thread calls it.

Precision follows ``ops.pipeline.make_forward_fn``: on the card the fast
mel kernel with a per-stream dB clamp (S >= 128 streams take ``tfb_fast``,
fewer ``row_fast``); on the CPU the exact plain frontend. On the card the
scoring forward of the fixed (S, window) shape is one CUDA-graph replay a
hop (ops/graphs.py); the ring and ``_emit`` stay on the host side of it.

Events: every scored window yields (stream, t_end_seconds, probs); keyword
triggers (prob >= threshold, default the GSC operating point 0.2) fire with
a refractory period so one utterance does not spam events.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..evaluate.calibration import apply_temperature
from ..evaluate.events import per_class_thresholds
from ..frontend import normalize_pcm16, quantize_pcm16
from ..ops.pipeline import make_forward_fn
from ..utils.device import resolve_device
from .service import resolve_calibration


@dataclasses.dataclass(frozen=True)
class StreamingConfig:
    window_seconds: float = 1.0
    hop_seconds: float = 0.25
    sample_rate: int = 16000
    threshold: float = 0.2          # keyword trigger threshold (GSC point)
    refractory_seconds: float = 1.0  # min gap between triggers per keyword
    n_audioset: int = 527
    use_kernel: Optional[bool] = None  # None: the fused kernel on CUDA
    # 'per_sample' (default): each stream's window clamps against its own
    # max, so co-batched streams never couple through the dB clamp;
    # 'torch' replicates torchaudio's batch-global clamp (offline parity).
    top_db_mode: str = "per_sample"
    # ring-buffer / transfer dtype. 'int16' halves the host->device bytes a
    # hop (the frontend folds 1/32768 into the DFT matrices, so scores are
    # bitwise the float32 ring's). Lossless for 16-bit PCM sources (raw
    # int16 chunks, or floats k/32768 decoded from 16-bit wavs); other
    # float sources are quantized to the nearest PCM step.
    dtype: str = "float32"


@dataclasses.dataclass
class Event:
    stream: int
    time: float            # stream time at window end, seconds
    probs: np.ndarray      # (outputdim,)
    triggers: list         # [(class_index, prob), ...] newly fired keywords


class MultiStreamTagger:
    """S always-on streams -> batched fixed-shape scoring.

    ``model`` (an ``nn.Module`` or a list of them, an ensemble) is copied
    onto ``device`` (default ``"cuda"``; raises without a GPU unless
    ``device="cpu"`` is asked for). ``calibration``: a scalar, a (C,)
    vector or a calibration-JSON path, applied in ``_emit`` before the
    keyword thresholds and before any detector sees the probabilities."""

    def __init__(self, model_cfg, model, n_streams: int = 1,
                 config: StreamingConfig = StreamingConfig(), calibration=None, *,
                 device="cuda"):
        if config.dtype not in ("float32", "int16"):
            raise ValueError(f"dtype must be 'float32' or 'int16', got {config.dtype!r}")
        self.cfg = config
        self.n_streams = n_streams
        self.calibration = resolve_calibration(calibration)
        self.device = resolve_device(device)
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        sr = config.sample_rate
        self._win = int(config.window_seconds * sr)
        self._hop = int(config.hop_seconds * sr)
        members = model if isinstance(model, (list, tuple)) else [model]
        members = [copy.deepcopy(m).to(self.device).eval() for m in members]
        use_kernel = config.use_kernel
        if use_kernel is None:
            use_kernel = self.device.type == "cuda"
        self._fwd = make_forward_fn(
            model_cfg, members if isinstance(model, (list, tuple)) else members[0],
            use_kernel=use_kernel, precision="fast" if use_kernel else "exact",
            top_db_mode=config.top_db_mode)
        self._np_dtype = np.int16 if config.dtype == "int16" else np.float32
        self._buf = np.zeros((n_streams, self._win), dtype=self._np_dtype)
        self._filled = np.zeros(n_streams, dtype=np.int64)   # samples seen
        self._since_hop = np.zeros(n_streams, dtype=np.int64)
        self._last_trigger: dict[tuple[int, int], float] = {}
        # the device ring of the steady-state feed_all loop (see the module
        # docstring); the host mirror is not shifted a hop there and goes
        # stale until _sync_host
        self._dev_buf: Optional[torch.Tensor] = None
        self._host_stale = False

    @contextlib.contextmanager
    def _on_stream(self):
        """The tagger's device work: inference mode, on the tagger's stream."""
        with torch.inference_mode():
            if self._stream is None:
                yield
            else:
                with torch.cuda.stream(self._stream):
                    yield

    def _to_buf_dtype(self, chunk: np.ndarray) -> np.ndarray:
        """Incoming audio (normalized float32 or raw int16 PCM) -> the ring
        buffer's dtype, through the conversion pair of the frontend (a bare
        cast either way would be 32768x off)."""
        chunk = np.asarray(chunk)
        if chunk.dtype == self._np_dtype:
            return chunk
        if self._np_dtype == np.int16:
            return np.asarray(quantize_pcm16(chunk))
        return normalize_pcm16(chunk)

    def _probs(self, batch: torch.Tensor) -> np.ndarray:
        """(n_streams, win) windows on the device -> (n_streams, C) host probs."""
        return self._fwd(batch).cpu().numpy()

    def feed(self, stream: int, chunk: np.ndarray) -> list[Event]:
        """Append audio to one stream; returns events for every window that
        became due (one per elapsed hop). Accepts normalized float32 or raw
        int16 PCM (converted to the configured buffer dtype)."""
        chunk = self._to_buf_dtype(np.asarray(chunk).reshape(-1))
        self._sync_host()
        self._dev_buf = None  # host buffer diverges from the device ring
        events = []
        pos = 0
        while pos < chunk.shape[0]:
            # fill until the next hop boundary
            need = self._hop - self._since_hop[stream]
            take = min(need, chunk.shape[0] - pos)
            self._push(stream, chunk[pos: pos + take])
            self._since_hop[stream] += take
            pos += take
            if self._since_hop[stream] >= self._hop:
                self._since_hop[stream] = 0
                if self._filled[stream] >= self._win:
                    events.extend(self._score([stream]))
        return events

    def feed_all(self, chunks: np.ndarray) -> list[Event]:
        """chunks (S, hop): advance every stream one hop and score the due
        ones in one batch (the steady-state service loop). Accepts
        normalized float32 or raw int16 PCM rows.

        In the steady state the ring lives on the device: the (S, hop) chunk
        is the only transfer of a hop."""
        chunks = np.asarray(chunks)
        if chunks.shape != (self.n_streams, self._hop):
            raise ValueError(f"feed_all takes ({self.n_streams}, {self._hop}) chunks, "
                             f"got {chunks.shape}")
        chunks = self._to_buf_dtype(chunks)
        n = self._hop
        self._filled += n
        # feed_all always advances exactly one hop and scores at its end:
        # a residual from a partial feed() is absorbed into this hop, so
        # later feed() boundaries stay hop-aligned
        self._since_hop[:] = 0
        due = np.flatnonzero(self._filled >= self._win).tolist()

        if n >= self._win or len(due) not in (0, self.n_streams):
            # degenerate hop or mixed feed()/feed_all cadence: host path
            self._sync_host()
            self._dev_buf = None
            self._host_advance(chunks)
            return self._score(due) if due else []

        with self._on_stream():
            if self._dev_buf is None:
                # (re)seed: advance the authoritative host buffer, upload it
                # once and score it directly; later hops ship only the chunk
                self._host_advance(chunks)
                self._dev_buf = torch.from_numpy(self._buf.copy()).to(self.device)
                return self._emit(due, self._probs(self._dev_buf)) if due else []
            # steady state: device ring only; the host mirror goes stale
            self._host_stale = True
            chunk = torch.from_numpy(chunks).to(self.device)
            self._dev_buf = torch.cat([self._dev_buf[:, n:], chunk], dim=1)
            return self._emit(due, self._probs(self._dev_buf)) if due else []

    def reset_stream(self, stream: int):
        """Clear one stream slot for reuse (session recycling): its ring,
        fill/hop counters, and keyword-refractory history. The next window
        on this slot scores only audio fed after the reset."""
        self._sync_host()
        self._dev_buf = None  # host buffer diverges from the device ring
        self._buf[stream] = 0
        self._filled[stream] = 0
        self._since_hop[stream] = 0
        for key in [k for k in self._last_trigger if k[0] == stream]:
            del self._last_trigger[key]

    def _host_advance(self, chunks: np.ndarray):
        """Vectorized all-streams ring shift on the host buffer."""
        n = self._hop
        if n >= self._win:
            self._buf[:] = chunks[:, -self._win:]
        else:
            self._buf[:, :-n] = self._buf[:, n:]
            self._buf[:, -n:] = chunks

    def _sync_host(self):
        """Rebuild the host mirror from the device ring if it went stale."""
        if self._host_stale:
            with self._on_stream():
                self._buf[:] = self._dev_buf.cpu().numpy()
            self._host_stale = False

    def _push(self, stream: int, piece: np.ndarray):
        n = piece.shape[0]
        if n == 0:
            return
        if n >= self._win:
            self._buf[stream] = piece[-self._win:]
        else:
            self._buf[stream, :-n] = self._buf[stream, n:]
            self._buf[stream, -n:] = piece
        self._filled[stream] += n

    def _score(self, streams: list[int]) -> list[Event]:
        """Host-buffer path: transfer the full windows of ``streams``, each
        in its own slot's row of an (n_streams, window) batch (one shape,
        and the rows the device ring scores them in, so the two paths give
        the same bits)."""
        batch = np.zeros((self.n_streams, self._win), self._np_dtype)
        batch[streams] = self._buf[streams]
        with self._on_stream():
            probs = self._probs(torch.from_numpy(batch).to(self.device))
        return self._emit(streams, probs[streams])

    def _emit(self, streams: list[int], probs: np.ndarray) -> list[Event]:
        """(k >= len(streams), outputdim) probs rows -> Events + triggers.
        Row i scores streams[i] (device-ring scoring passes all-stream
        probs, where streams == range(n_streams), so rows still align)."""
        if self.calibration is not None:
            probs = apply_temperature(probs, self.calibration)
        events = []
        for i, s in enumerate(streams):
            t = self._filled[s] / self.cfg.sample_rate
            p = probs[i]
            triggers = []
            for k in np.flatnonzero(p[self.cfg.n_audioset:] >= self.cfg.threshold):
                cls = int(self.cfg.n_audioset + k)
                last = self._last_trigger.get((s, cls), -np.inf)
                if t - last >= self.cfg.refractory_seconds:
                    self._last_trigger[(s, cls)] = t
                    triggers.append((cls, float(p[cls])))
            events.append(Event(stream=s, time=float(t), probs=p, triggers=triggers))
        return events


class StreamingTagger(MultiStreamTagger):
    """Single-stream convenience wrapper."""

    def __init__(self, model_cfg, model, config: StreamingConfig = StreamingConfig(),
                 calibration=None, *, device="cuda"):
        super().__init__(model_cfg, model, n_streams=1, config=config,
                         calibration=calibration, device=device)

    def feed_audio(self, chunk: np.ndarray) -> list[Event]:
        return self.feed(0, chunk)


@dataclasses.dataclass
class SoundEvent:
    """A closed (finished) sound event detected online."""
    stream: int
    cls: int
    onset: float           # seconds, stream time
    offset: float          # seconds, stream time
    peak_prob: float


class OnlineEventDetector:
    """Online SED over the window-probability stream: hysteresis
    thresholding with hang time, the streaming counterpart of
    ``evaluate.events.extract_events`` (which needs the whole clip).

    Feed it every scored window (MultiStreamTagger events): a class's run
    OPENS when its prob >= on_threshold, stays open while probs remain
    >= off_threshold, and CLOSES once the class has been below
    off_threshold for ``hang_seconds`` of stream time, at which point a
    SoundEvent is emitted if the run lasted >= min_duration.

    Tracked classes default to the AudioSet range [0, n_audioset); pass
    ``classes`` to watch a subset. Thresholds are scalars or per-class
    specs (a {class: th} mapping as ``evaluate.events.load_thresholds``
    gives it, keyed by model class index). When a per-class on-threshold
    dips below a scalar off-threshold, that class's off clamps to its on
    value; an explicit scalar pair with off > on raises.
    """

    def __init__(self, on_threshold=0.5, off_threshold=0.3,
                 hang_seconds: float = 0.0, min_duration: float = 0.0,
                 classes: Optional[list] = None, n_audioset: int = 527,
                 window_seconds: float = 1.0):
        if np.isscalar(on_threshold) and np.isscalar(off_threshold) \
                and off_threshold > on_threshold:
            raise ValueError(f"hysteresis needs off <= on, got off {off_threshold} > "
                             f"on {on_threshold}")
        self.on_threshold = on_threshold
        self.off_threshold = off_threshold
        self.hang_seconds = hang_seconds
        self.min_duration = min_duration
        self.window_seconds = window_seconds
        self._classes = (np.arange(n_audioset) if classes is None
                         else np.asarray(sorted(classes), dtype=np.int64))
        # resolve over the full model index space, then gather the tracked
        # subset; mapping entries for untracked classes are ignored
        n_full = (int(self._classes.max()) + 1 if self._classes.size
                  else n_audioset)

        def _resolve(spec, default):
            if isinstance(spec, dict):
                spec = {c: t for c, t in spec.items()
                        if c == "default" or 0 <= int(c) < n_full}
            return per_class_thresholds(spec, n_full, default=default)[self._classes]

        self._on = _resolve(on_threshold, 0.5)
        self._off = np.minimum(_resolve(off_threshold, 0.3), self._on)
        # (stream, cls) -> [onset, last_active_time, peak]
        self._open: dict[tuple[int, int], list] = {}

    def update(self, stream: int, time: float, probs: np.ndarray) -> list[SoundEvent]:
        """One scored window (stream time ``time`` = window END, seconds);
        returns events that closed. The window covers
        [time - window_seconds, time]."""
        p = np.asarray(probs)[self._classes]
        onset_t = max(0.0, time - self.window_seconds)
        closed = []
        hot = set(np.flatnonzero(p >= self._on))
        warm = set(np.flatnonzero(p >= self._off))
        for i in hot:
            cls = int(self._classes[i])
            run = self._open.get((stream, cls))
            if run is None:
                self._open[(stream, cls)] = [onset_t, time, float(p[i])]
            else:
                run[1] = time
                run[2] = max(run[2], float(p[i]))
        for (s, cls), run in list(self._open.items()):
            if s != stream:
                continue
            i = np.searchsorted(self._classes, cls)
            still_warm = i < len(self._classes) and self._classes[i] == cls \
                and i in warm
            if still_warm:
                run[1] = time
            elif time - run[1] >= self.hang_seconds:
                ev = self._close(s, cls, run)
                if ev is not None:
                    closed.append(ev)
                del self._open[(s, cls)]
        return closed

    def flush(self, stream: Optional[int] = None) -> list[SoundEvent]:
        """Close every open run (end of stream); returns the final events."""
        closed = []
        for (s, cls), run in list(self._open.items()):
            if stream is not None and s != stream:
                continue
            ev = self._close(s, cls, run)
            if ev is not None:
                closed.append(ev)
            del self._open[(s, cls)]
        return closed

    def _close(self, stream: int, cls: int, run) -> Optional[SoundEvent]:
        onset, last, peak = run
        if last - onset < self.min_duration:
            return None
        return SoundEvent(stream=stream, cls=cls, onset=float(onset),
                          offset=float(last), peak_prob=peak)
