"""HTTP front for the batching TaggingService (stdlib only), counterpart of
``uit_mobile_tpu/serve/http.py``.

Concurrent requests are batched onto the device by the service's queue (one
request thread per connection via ``ThreadingHTTPServer``; the service
worker groups whatever is pending into fixed-shape bucket batches).

Endpoints:
    GET  /healthz          liveness + model/device info + request stats
    GET  /metrics          the same counters in Prometheus text format
    GET  /labels           the index -> display-name map
    POST /reload           weight swap without downtime (requires reload_fn;
      uit-serve wires it to re-read the checkpoint it was started from;
      in-flight batches finish on the old weights, /healthz exposes
      weights_version)
    POST /tag[?k=5&full=1] score one clip; body is either
        - a RIFF/WAV blob (Content-Type audio/wav; must match the service
          sample rate; multichannel is downmixed by mean), or
        - raw samples with ?format=pcm16 (int16 LE mono) or ?format=f32
          (float32 LE mono, normalized to [-1, 1]).
      Response: {"top": [{"index", "label", "prob"}...], "n_samples": N}
      (+ "probs": [all C floats] when full=1).
    POST /events[?threshold=0.5&median=1&min_duration=0&merge_gap=0
                 &per_class=CLS:TH,CLS:TH]
      temporal tagging: same body formats; responds
      {"events": [{"index", "label", "onset", "offset"}...],
       "duration": seconds}. Requires a ``framewise_fn``
      (make_framewise_fn below); 501 otherwise. Clips are zero-padded to
      whole seconds; events are clamped/dropped to the true clip extent.
    POST /stream/open[?on=0.5&off=0.3&hang=0&min_duration=0&classes=i,j
                      &per_class=CLS:TH,...]
    POST /stream/<id>/feed      POST /stream/<id>/close
      real-time session streaming (requires ``stream_sessions``, a
      StreamSessions): open a session, feed audio chunks of any size (same
      body formats as /tag), get back every window that became due (top-k +
      keyword triggers) plus closed sound events; close flushes the
      detector and recycles the slot.

Status codes: 400 bad body or parameter, 404 unknown path or session, 411
no Content-Length, 413 clip longer than max_seconds, 429 no free stream
slot, 500 reload failed, 501 surface not enabled, 503 service closed.
"""

from __future__ import annotations

import contextlib
import copy
import json
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from ..data import read_wav_bytes
from ..evaluate.calibration import apply_temperature
from ..evaluate.events import extract_events
from ..frontend import normalize_pcm16
from ..models import MobileNetV2Config, UITConfig
from ..ops import pipeline
from ..utils.device import resolve_device
from .streaming import MultiStreamTagger, OnlineEventDetector, StreamingConfig


def _parse_per_class(text: str) -> dict:
    """``CLS:TH,CLS:TH`` query value -> {class_index: threshold}, the wire
    form of a tuned per-class operating point. Raises ValueError on
    malformed pairs."""
    spec: dict = {}
    for pair in text.split(","):
        if not pair:
            continue
        cls, _, th = pair.partition(":")
        c = int(cls)
        if c < 0:
            raise ValueError(f"negative class index {c} in per_class")
        spec[c] = float(th)
    return spec


def make_framewise_fn(model_cfg, model, *, max_seconds: int = 10,
                      use_kernel: bool | None = None, device="cuda"):
    """-> fn(wav (T,) float32) -> (probs (S, C) numpy, times (S, 2) float64 s).

    The single-clip temporal-tagging scorer behind POST /events, on
    ``ops.pipeline.make_framewise_fn``: the bft layout (the exact row
    kernel on the card for the UiT family, the rfft reference elsewhere),
    the dB clamp per sample, clips zero-padded to whole seconds up to
    ``max_seconds``, the segment times float64 from the host. ``model`` is
    copied onto ``device``; a list of models is an ensemble whose member
    probabilities are averaged. MobileNetV2 keeps its own frontend, as the
    JAX scorer does."""
    if not isinstance(model_cfg, (UITConfig, MobileNetV2Config)):
        # fail at server build, not at the first POST /events
        raise TypeError(f"no framewise forward for {type(model_cfg).__name__}")
    dev = resolve_device(device)
    ensemble = isinstance(model, (list, tuple))
    members = [copy.deepcopy(m).to(dev).eval() for m in (model if ensemble else [model])]
    uit_family = isinstance(model_cfg, UITConfig)
    if use_kernel is None:
        use_kernel = dev.type == "cuda"
    fwd = pipeline.make_framewise_fn(
        model_cfg, members if ensemble else members[0],
        use_kernel=use_kernel and uit_family, precision="exact",
        top_db_mode="per_sample" if uit_family else None)
    stream = torch.cuda.current_stream(dev) if dev.type == "cuda" else None
    sr = model_cfg.frontend.sample_rate

    def fn(wav: np.ndarray):
        wav = np.asarray(wav, dtype=np.float32)
        pad_to = min(max(-(-wav.shape[0] // sr), 1), max_seconds) * sr
        padded = np.zeros((1, pad_to), dtype=np.float32)
        padded[0, : wav.shape[0]] = wav[:pad_to]
        # the weights were copied on the stream current when fn was made:
        # score there, whichever handler thread calls
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            probs, times = fwd(padded)
            probs = probs[0].cpu().numpy()
        return probs, times

    fn.uses_kernel = fwd.uses_kernel
    return fn


class StreamSessions:
    """HTTP-session streaming: real-time tagging over plain POSTs.

    Each session owns one slot of a shared ``MultiStreamTagger`` (the slot
    count is the batch dim) plus its own ``OnlineEventDetector``. Clients
    open a session, POST audio chunks of any size, and receive the windows
    that became due, newly fired keyword triggers, and closed sound events;
    closing flushes the detector. Slots recycle through ``reset_stream``;
    idle sessions expire lazily after ``idle_seconds``.

    One manager lock serializes every call (the tagger is stateful); the
    scale knob for massive stream counts is ``MultiStreamTagger.feed_all``
    driven by a single producer, not HTTP sessions.
    """

    def __init__(self, model_cfg, model, config=None, max_sessions: int = 32,
                 idle_seconds: float = 600.0, calibration=None, *, device="cuda"):
        self.config = config or StreamingConfig()
        self.max_sessions = max_sessions
        self.device = device
        # deployment-level temperature scaling, applied inside the tagger
        # (before trigger thresholds and detectors); it survives reload()
        self._calibration = calibration
        self.tagger = MultiStreamTagger(model_cfg, model, n_streams=max_sessions,
                                        config=self.config, calibration=calibration,
                                        device=device)
        self.idle_seconds = idle_seconds
        self._free = list(range(max_sessions - 1, -1, -1))
        self._sessions: dict = {}  # id -> {slot, detector, last_used}
        self._lock = threading.Lock()

    def reload(self, model_cfg, model) -> bool:
        """Swap to new model weights IF no sessions are active (a live
        session's ring buffer and detector state belong to the weights that
        scored them). Returns True on swap, False when active sessions defer
        it; callers retry once the slots drain (idle expiry bounds the wait)."""
        with self._lock:
            self._expire_locked()
            if self._sessions:
                return False
            self.tagger = MultiStreamTagger(
                model_cfg, model, n_streams=self.max_sessions, config=self.config,
                calibration=self._calibration, device=self.device)
            return True

    @property
    def active_sessions(self) -> int:
        with self._lock:
            self._expire_locked()
            return len(self._sessions)

    # every public method takes the lock: the tagger and the session table
    # are shared across HTTP handler threads
    def open(self, **detector_kwargs) -> dict:
        with self._lock:
            self._expire_locked()
            if not self._free:
                raise LookupError(f"all {len(self._sessions)} stream sessions in use")
            det = OnlineEventDetector(n_audioset=self.config.n_audioset,
                                      window_seconds=self.config.window_seconds,
                                      **detector_kwargs)
            slot = self._free.pop()
            sid = uuid.uuid4().hex
            self._sessions[sid] = {"slot": slot, "detector": det,
                                   "last_used": time.monotonic()}
            return {"id": sid,
                    "window_seconds": self.config.window_seconds,
                    "hop_seconds": self.config.hop_seconds,
                    "sample_rate": self.config.sample_rate}

    def feed(self, sid: str, chunk: np.ndarray):
        """-> (window Events, closed SoundEvents)."""
        with self._lock:
            sess = self._get_locked(sid)
            windows = self.tagger.feed(sess["slot"], chunk)
            closed = []
            for ev in windows:
                closed.extend(sess["detector"].update(ev.stream, ev.time, ev.probs))
            return windows, closed

    def close(self, sid: str):
        """Flush + recycle; -> the detector's final SoundEvents."""
        with self._lock:
            sess = self._get_locked(sid)
            closed = sess["detector"].flush(sess["slot"])
            self._release_locked(sid)
            return closed

    def _get_locked(self, sid: str) -> dict:
        self._expire_locked()
        sess = self._sessions.get(sid)
        if sess is None:
            raise KeyError(f"unknown or expired stream session {sid!r}")
        sess["last_used"] = time.monotonic()
        return sess

    def _release_locked(self, sid: str):
        sess = self._sessions.pop(sid)
        self.tagger.reset_stream(sess["slot"])
        self._free.append(sess["slot"])

    def _expire_locked(self):
        now = time.monotonic()
        for sid, sess in list(self._sessions.items()):
            if now - sess["last_used"] > self.idle_seconds:
                self._release_locked(sid)


class _Stats:
    """Thread-safe request counters + a sliding latency window."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self._lat = []  # ring buffer of the last `window` seconds
        self._window = window
        self._i = 0

    def record(self, seconds: float, ok: bool):
        with self._lock:
            self.requests += 1
            self.errors += not ok
            if len(self._lat) < self._window:
                self._lat.append(seconds)
            else:
                self._lat[self._i] = seconds
                self._i = (self._i + 1) % self._window

    def snapshot(self) -> dict:
        with self._lock:
            lat = sorted(self._lat)
            n_req, n_err = self.requests, self.errors

        def pct(p):
            return round(lat[min(len(lat) - 1, int(p * len(lat)))] * 1e3, 2) if lat else None

        return {"requests": n_req, "errors": n_err,
                "latency_ms": {"p50": pct(0.50), "p95": pct(0.95), "p99": pct(0.99)}}


def _device_info(service) -> dict:
    """/healthz's platform ('gpu' or 'cpu') and the card's name."""
    dev = getattr(service, "device", None)
    if dev is not None and dev.type == "cuda":
        return {"platform": "gpu", "device": torch.cuda.get_device_name(dev)}
    return {"platform": "cpu", "device": "cpu"}


def make_http_server(service, labels=None, host: str = "127.0.0.1",
                     port: int = 8000, topk: int = 5,
                     model_name: str = "?", quiet: bool = True,
                     framewise_fn=None, stream_sessions=None,
                     reload_fn=None):
    """-> a ThreadingHTTPServer wired to ``service`` (not yet serving).

    Call ``serve_forever()`` (blocking) or drive it from a thread; the
    caller owns the service lifecycle (``service.close()`` after
    ``shutdown()``). ``framewise_fn`` (see make_framewise_fn) enables POST
    /events; ``stream_sessions`` (a StreamSessions) enables POST /stream/*.

    ``reload_fn`` enables POST /reload: a no-argument callable returning an
    info dict for the response. It may include the private key
    ``"_framewise_fn"``, a replacement /events scorer built from the new
    weights, applied (and stripped) by the handler so temporal tagging
    swaps in the same reload.
    """
    labels = {int(k): v for k, v in (labels or {}).items()}
    sr = service.cfg.sample_rate
    max_samples = service.cfg.max_seconds * sr
    # mutable holder: POST /reload swaps the /events scorer in place
    framewise = {"fn": framewise_fn}
    stats = _Stats()
    device_info = _device_info(service)

    def label(i) -> str:
        return labels.get(int(i), f"class_{int(i)}")

    def sound_event(ev) -> dict:
        return {"index": int(ev.cls), "label": label(ev.cls),
                "onset": float(ev.onset), "offset": float(ev.offset),
                "peak_prob": float(ev.peak_prob)}

    class Handler(BaseHTTPRequestHandler):
        server_version = "uit-serve"
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # noqa: N802
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *args)

        # ----------------------------------------------------------- util
        def _record_now(self, code: int):
            """Record the request BEFORE the response reaches the client: a
            caller that reads the response and then GETs /healthz sees it
            counted."""
            t0 = getattr(self, "_record_t0", None)
            if t0 is not None:
                self._record_t0 = None
                stats.record(time.perf_counter() - t0, code < 400)

        def _send(self, code: int, body: bytes, ctype: str):
            self._status = code
            self._record_now(code)
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _json(self, code: int, payload: dict):
            self._send(code, json.dumps(payload).encode(), "application/json")

        def _error(self, code: int, msg: str):
            self._json(code, {"error": msg})

        # ------------------------------------------------------------ GET
        def do_GET(self):  # noqa: N802
            path = urlparse(self.path).path
            if path == "/healthz":
                self._json(200, {
                    "status": "ok",
                    "model": model_name,
                    **device_info,
                    "sample_rate": sr,
                    "max_seconds": service.cfg.max_seconds,
                    "batch_size": service.cfg.batch_size,
                    "weights_version": getattr(service, "weights_version", None),
                    "calibrated": getattr(service, "calibration", None) is not None,
                    **stats.snapshot(),
                })
            elif path == "/metrics":
                self._metrics()
            elif path == "/labels":
                self._json(200, {str(k): v for k, v in labels.items()})
            else:
                self._error(404, f"unknown path {path!r}")

        def _metrics(self):
            """GET /metrics: the counters in Prometheus text format."""
            snap = stats.snapshot()
            lines = [
                "# TYPE uit_requests_total counter",
                f"uit_requests_total {snap['requests']}",
                "# TYPE uit_errors_total counter",
                f"uit_errors_total {snap['errors']}",
                "# TYPE uit_weights_version gauge",
                f"uit_weights_version {getattr(service, 'weights_version', 0) or 0}",
                "# TYPE uit_request_latency_ms summary",
            ]
            for q, key in (("0.5", "p50"), ("0.95", "p95"), ("0.99", "p99")):
                v = snap["latency_ms"][key]
                if v is not None:
                    lines.append(f'uit_request_latency_ms{{quantile="{q}"}} {v}')
            if stream_sessions is not None:
                lines += ["# TYPE uit_stream_sessions_active gauge",
                          f"uit_stream_sessions_active {stream_sessions.active_sessions}"]
            self._send(200, ("\n".join(lines) + "\n").encode(),
                       "text/plain; version=0.0.4; charset=utf-8")

        # ----------------------------------------------------------- POST
        def do_POST(self):  # noqa: N802
            path = urlparse(self.path).path
            recordable = path in ("/tag", "/events") or path.startswith("/stream/")
            self._record_t0 = time.perf_counter() if recordable else None
            self._status = 200
            try:
                self._handle_post()
            finally:
                # for handlers that raised before responding; the normal
                # path records in _send
                if recordable:
                    self._record_now(self._status)

        def _handle_post(self):
            url = urlparse(self.path)
            is_stream = url.path.startswith("/stream/")
            if url.path not in ("/tag", "/events", "/reload") and not is_stream:
                self._error(404, f"unknown path {url.path!r}")
                return
            if url.path == "/reload":
                self._reload()
                return
            if is_stream and stream_sessions is None:
                self._error(501, "streaming not enabled: start the server with "
                                 "stream_sessions (uit-serve --http enables it for "
                                 "model-backed serving)")
                return
            if url.path == "/events" and framewise["fn"] is None:
                self._error(501, "temporal tagging not enabled: start the server "
                                 "with a framewise_fn (uit-serve --http enables it "
                                 "when the model supports it)")
                return
            q = parse_qs(url.query)
            stream_id = None
            if is_stream:
                parts = url.path.split("/")[2:]  # after "/stream/"
                if parts == ["open"]:
                    self._stream_open(q)
                    return
                if len(parts) == 2 and parts[1] == "close":
                    self._stream_close(parts[0])
                    return
                if not (len(parts) == 2 and parts[1] == "feed"):
                    self._error(404, f"unknown path {url.path!r}")
                    return
                # /stream/<id>/feed takes the shared audio-body decode below
                stream_id = parts[0]
            try:
                length = int(self.headers.get("Content-Length", ""))
            except ValueError:
                self._error(411, "Content-Length required")
                return
            # WAV container overhead is tiny; 4 bytes/sample bounds f32
            if length > max_samples * 4 + 65536:
                self._error(413, f"body exceeds max_seconds={service.cfg.max_seconds} "
                                 f"at {sr} Hz")
                return
            body = self.rfile.read(length)
            try:
                wav = self._decode(body, q)
            except ValueError as e:
                self._error(400, str(e))
                return
            if wav.shape[0] > max_samples:
                self._error(413, f"clip of {wav.shape[0]} samples exceeds "
                                 f"max_seconds={service.cfg.max_seconds}")
                return
            if wav.shape[0] == 0:
                self._error(400, "empty clip")
                return
            if is_stream:
                self._stream_feed(stream_id, wav, q)
            elif url.path == "/events":
                self._events(wav, q)
            else:
                self._tag(wav, q)

        def _tag(self, wav: np.ndarray, q):
            try:
                k = int(q.get("k", [topk])[0])
            except ValueError as e:
                self._error(400, f"bad k: {e}")
                return
            try:
                probs = np.asarray(service.submit(wav).result(timeout=120))
            except RuntimeError as e:  # service closed / dispatch failure
                self._error(503, str(e))
                return
            k = max(1, min(k, probs.shape[0]))
            top_idx = np.argsort(probs)[::-1][:k]
            out = {"top": [{"index": int(i), "label": label(i), "prob": float(probs[i])}
                           for i in top_idx],
                   "n_samples": int(wav.shape[0])}
            if q.get("full", ["0"])[0] not in ("0", "", "false"):
                out["probs"] = [float(p) for p in probs]
            self._json(200, out)

        def _reload(self):
            """POST /reload: weight swap (see reload_fn)."""
            if reload_fn is None:
                self._error(501, "hot reload not enabled: start the server with a "
                                 "reload_fn (uit-serve --http wires it for "
                                 "checkpoint-backed serving)")
                return
            try:
                info = dict(reload_fn())
            except Exception as e:  # noqa: BLE001 - reported to the caller as a 500
                self._error(500, f"reload failed: {e}")
                return
            new_fw = info.pop("_framewise_fn", None)
            if new_fw is not None:
                framewise["fn"] = new_fw
                info.setdefault("events", "reloaded")
            self._json(200, info)

        def _stream_open(self, q):
            kwargs = {}
            try:
                for qk, kk in (("on", "on_threshold"), ("off", "off_threshold"),
                               ("hang", "hang_seconds"), ("min_duration", "min_duration")):
                    if qk in q:
                        kwargs[kk] = float(q[qk][0])
                if "per_class" in q:
                    # tuned per-class on-thresholds on top of the scalar `on`
                    spec = _parse_per_class(q["per_class"][0])
                    spec["default"] = kwargs.pop("on_threshold", 0.5)
                    kwargs["on_threshold"] = spec
                if "classes" in q:
                    kwargs["classes"] = [int(c) for c in q["classes"][0].split(",") if c]
            except ValueError as e:
                self._error(400, f"bad stream parameter: {e}")
                return
            try:
                self._json(200, stream_sessions.open(**kwargs))
            except LookupError as e:  # slots exhausted
                self._error(429, str(e))
            except ValueError as e:  # detector arguments
                self._error(400, str(e))

        def _stream_feed(self, sid: str, wav: np.ndarray, q):
            try:
                k = max(1, int(q.get("k", [topk])[0]))
            except ValueError as e:
                self._error(400, f"bad k: {e}")
                return
            try:
                windows, closed = stream_sessions.feed(sid, wav)
            except KeyError as e:
                self._error(404, str(e))
                return
            out_w = []
            for ev in windows:
                top_idx = np.argsort(ev.probs)[::-1][:k]
                out_w.append({
                    "time": float(ev.time),
                    "top": [{"index": int(i), "label": label(i), "prob": float(ev.probs[i])}
                            for i in top_idx],
                    "triggers": [{"index": int(c), "label": label(c), "prob": float(p)}
                                 for c, p in ev.triggers],
                })
            self._json(200, {"windows": out_w,
                             "events": [sound_event(e) for e in closed]})

        def _stream_close(self, sid: str):
            try:
                closed = stream_sessions.close(sid)
            except KeyError as e:
                self._error(404, str(e))
                return
            self._json(200, {"events": [sound_event(e) for e in closed]})

        def _events(self, wav: np.ndarray, q):
            try:
                threshold = float(q.get("threshold", ["0.5"])[0])
                if "per_class" in q:
                    spec = _parse_per_class(q["per_class"][0])
                    spec["default"] = threshold
                    threshold = spec
                median = int(q.get("median", ["1"])[0])
                min_duration = float(q.get("min_duration", ["0"])[0])
                merge_gap = float(q.get("merge_gap", ["0"])[0])
                if median < 1 or median % 2 == 0:
                    raise ValueError("median must be odd and >= 1")
            except ValueError as e:
                self._error(400, f"bad event parameter: {e}")
                return
            if wav.dtype == np.int16:
                wav = normalize_pcm16(wav)
            duration = wav.shape[0] / sr
            probs, times = framewise["fn"](wav)
            cal = getattr(service, "calibration", None)
            if cal is not None:
                # the deployment's temperature scaling covers /events too,
                # before the thresholds (the calibration outlives reloads)
                probs = apply_temperature(probs, cal)
            try:
                events = extract_events(times, probs, threshold=threshold,
                                        median_kernel=median, min_duration=min_duration,
                                        merge_gap=merge_gap)
            except ValueError as e:  # per_class index >= model outputdim
                self._error(400, f"bad event parameter: {e}")
                return
            out = []
            for cls, onset, offset in events:
                # padding to whole seconds can extend the last segments past
                # the true clip: clamp, and drop padding-only events
                if onset >= duration:
                    continue
                out.append({"index": int(cls), "label": label(cls),
                            "onset": float(onset), "offset": float(min(offset, duration))})
            self._json(200, {"events": out, "duration": duration})

        def _decode(self, body: bytes, q) -> np.ndarray:
            fmt = q.get("format", [None])[0]
            ctype = (self.headers.get("Content-Type") or "").split(";")[0]
            if fmt is None and (body[:4] == b"RIFF" or ctype in
                                ("audio/wav", "audio/x-wav", "audio/wave")):
                try:
                    data, got_sr = read_wav_bytes(body)
                except Exception as e:  # noqa: BLE001 - any decode failure is a 400
                    raise ValueError(f"undecodable WAV body: {e}") from None
                if got_sr != sr:
                    raise ValueError(f"sample rate {got_sr} != service rate {sr}; "
                                     f"resample client-side")
                return data.mean(axis=0) if data.shape[0] > 1 else data[0]
            if fmt == "pcm16":
                if len(body) % 2:
                    raise ValueError("pcm16 body length must be even")
                return np.frombuffer(body, dtype="<i2")
            if fmt == "f32":
                if len(body) % 4:
                    raise ValueError("f32 body length must be a multiple of 4")
                return np.frombuffer(body, dtype="<f4")
            raise ValueError("send a RIFF/WAV body (Content-Type audio/wav) or raw "
                             "samples with ?format=pcm16|f32")

    return _Server((host, port), Handler)


class _Server(ThreadingHTTPServer):
    """The stdlib threading server with a listen backlog for bursts: the
    stdlib's backlog of 5 drops the connections of a burst beyond it (their
    clients retry after a second, or are reset)."""

    daemon_threads = True
    request_queue_size = 1024


def serve_http(service, labels=None, host="127.0.0.1", port=8000,
               topk=5, model_name="?", quiet=False,
               ready_event: threading.Event | None = None,
               framewise_fn=None, stream_sessions=None, reload_fn=None):
    """Blocking convenience wrapper: serve until KeyboardInterrupt."""
    server = make_http_server(service, labels=labels, host=host, port=port,
                              topk=topk, model_name=model_name, quiet=quiet,
                              framewise_fn=framewise_fn,
                              stream_sessions=stream_sessions,
                              reload_fn=reload_fn)
    if ready_event is not None:
        ready_event.set()
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
    return server
