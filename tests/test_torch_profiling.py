"""The port's profiling hooks (utils/profiling.py): the gap clustering of
device_dispatch_ms on synthetic chrome traces shaped as torch.profiler
exports them (device events by category: kernel, gpu_memcpy, gpu_memset),
the same cases as tests/test_profiling.py; trace() and step_timer on the
CPU."""

import gzip
import json

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch.utils.profiling import (device_dispatch_ms, device_memory_stats,
                                                  step_timer, trace)


def _write_trace(tmp_path, events, gz=True):
    d = tmp_path / "run1"
    d.mkdir(parents=True)
    name = "host.trace.json.gz" if gz else "host.trace.json"
    with (gzip.open if gz else open)(d / name, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return str(tmp_path)


def _op(pid, tid, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "pid": pid, "tid": tid, "ts": ts, "dur": dur,
            "name": "mel_kernel"}


@pytest.mark.parametrize("gz", [True, False])
def test_clusters_blocking_dispatches(tmp_path, gz):
    """3 dispatches of 3 device ops each (a kernel, a memcpy, a memset),
    separated by more than min_gap of idle: three clusters, each the sum
    of its ops' busy time; host events are ignored."""
    events, t = [], 0
    for _ in range(3):
        for cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            events.append(_op(0, 7, t, 100, cat))
            t += 120  # 20 us gaps inside a dispatch
        t += 30_000  # a 30 ms host round trip between dispatches
    events.append(_op(1234, 1, 0, 10_000_000, cat="cpu_op"))
    out = device_dispatch_ms(_write_trace(tmp_path, events, gz))
    np.testing.assert_allclose(out, [0.3, 0.3, 0.3])


def test_picks_busiest_device_timeline(tmp_path):
    events = []
    for i in range(4):
        events.append(_op(0, 7, i * 50_000, 2_000))  # main stream: 2 ms dispatches
        events.append(_op(0, 9, i * 50_000, 5))  # a sparse side stream
    np.testing.assert_allclose(device_dispatch_ms(_write_trace(tmp_path, events)), [2.0] * 4)


def test_no_device_timeline_returns_empty(tmp_path):
    events = [_op(1234, 1, 0, 100, cat="cpu_op")]
    assert device_dispatch_ms(_write_trace(tmp_path, events)) == []


def test_missing_trace_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        device_dispatch_ms(str(tmp_path))


def test_overlapping_ops_cluster_once(tmp_path):
    events = [_op(0, 7, 0, 1000), _op(0, 7, 500, 1000), _op(0, 7, 42_000, 1000)]
    np.testing.assert_allclose(device_dispatch_ms(_write_trace(tmp_path, events)), [2.0, 1.0])


def test_trace_and_timer_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with trace(str(tmp_path / "prof")) as prof:
        (x @ x).sum()
    assert prof is not None
    paths = list((tmp_path / "prof").glob("*.trace.json.gz"))
    assert len(paths) == 1
    assert device_dispatch_ms(str(tmp_path / "prof")) == []  # no card, no device events
    with step_timer(x) as t:
        (x @ x).sum()
    assert t.elapsed_ms >= 0.0
    if not torch.cuda.is_available():
        assert device_memory_stats() == {}
