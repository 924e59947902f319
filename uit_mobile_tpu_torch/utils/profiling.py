"""Profiling and tracing hooks, counterpart of ``uit_mobile_tpu/utils/profiling.py``.

Usage:
    with trace("profiles/run1"):               # chrome://tracing or Perfetto
        fwd(batch)

    with step_timer(batch) as t:                # CUDA events for a CUDA tensor
        fwd(batch)
    t.elapsed_ms

    device_dispatch_ms("profiles/run1")         # device ms per dispatch
"""

from __future__ import annotations

import contextlib
import glob
import gzip
import json
import os
import time
from collections import defaultdict

import torch

# chrome-trace categories of the events that run on the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler trace around a block (host and, with a card, device
    timelines), exported as ``<logdir>/<time>.trace.json.gz`` on exit."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, f"{time.time_ns()}.trace.json.gz"))


class step_timer:
    """Elapsed ms of a block: CUDA events around it when ``ref`` (a tensor
    or a device) lies on the card, synchronized on exit; the host clock
    otherwise."""

    def __init__(self, ref=None):
        dev = ref.device if isinstance(ref, torch.Tensor) else (
            torch.device(ref) if ref is not None else None)
        self._cuda = dev is not None and dev.type == "cuda"

    def __enter__(self):
        if self._cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._end = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            self._end.record()
            self._end.synchronize()
            self.elapsed_ms = self._start.elapsed_time(self._end)
        else:
            self.elapsed_ms = (time.perf_counter() - self._t0) * 1e3
        return False


def _load_trace(logdir: str) -> list:
    paths = sorted(glob.glob(f"{logdir}/**/*.trace.json*", recursive=True),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {logdir}")
    opener = gzip.open if paths[-1].endswith(".gz") else open
    with opener(paths[-1], "rt") as f:
        return json.load(f)["traceEvents"]


def device_dispatch_ms(logdir: str, min_gap_us: float = 500.0) -> list[float]:
    """Per-dispatch DEVICE busy time (ms) from the newest trace under ``logdir``.

    Takes the trace's device events (kernels, memcpys, memsets: the
    ``DEVICE_CATEGORIES``) on the busiest device timeline (one CUDA stream)
    and clusters them into dispatches at idle gaps longer than
    ``min_gap_us``; each cluster's summed busy time is one dispatch's
    device time. Valid when the traced region ran blocking dispatches, each
    separated by a host round trip. The same clustering as the JAX
    module's, over torch.profiler's chrome trace."""
    rows = defaultdict(list)  # (pid, tid) -> [(ts, dur)], microseconds
    for e in _load_trace(logdir):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES:
            rows[(e["pid"], e["tid"])].append((float(e["ts"]), float(e.get("dur", 0))))
    if not rows:
        return []
    evs = sorted(max(rows.values(), key=lambda v: sum(d for _, d in v)))
    clusters, busy, prev_end = [], 0.0, None
    for ts, dur in evs:
        if prev_end is not None and ts - prev_end > min_gap_us and busy:
            clusters.append(busy)
            busy = 0.0
        busy += dur
        prev_end = ts + dur if prev_end is None else max(prev_end, ts + dur)
    if busy:
        clusters.append(busy)
    return [c / 1e3 for c in clusters]


def device_memory_stats() -> dict:
    """Per-card memory of the caching allocator (bytes in use now, at peak,
    and the card's total), from ``torch.cuda.memory_stats``; {} without a
    card."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return out
