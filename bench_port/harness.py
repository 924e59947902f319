"""The benchmark's core: one cell of ``BENCHMARK.json`` run once.

Everything that belongs to one configuration, traffic mix or metric lives
in a file of its own, found by the name that ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the model's sizes, as run (``file`` of the
  configuration's entry);
- ``traffic/<traffic>.json``: the mix's parameters, and under ``driver``
  the module of ``drivers/`` that runs it;
- ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's value
  from the run's record, or None where the run holds nothing to read. A
  metric split by the cells' kind (``idle.train``, ``idle.<kind>``) without a
  file of its own is read by its family's file (``metrics/idle.py``).

A driver module has ``setup(ctx)``, which returns an object with
``window(seconds, tracer) -> record`` (the measured window, then with a
``Tracer`` a traced stretch of the same load), ``check() -> [Check]``
(the comparison with the plain reference, once the window has closed and
the program is freed) and ``close()``; and ``control(ctx)``, the
control's readings (``control.py``). The record is a dict that the metric
readers read: the driver's ``window_s``, ``attempted``, ``failed`` and
counts; the harness adds ``setup_s``, ``memory_peak_bytes`` (read before
the comparison) and, with ``--trace 1``, ``trace`` (``summarize_trace``).
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parent.parent  # the checkout
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "uit_mobile_tpu")
SPAN_PREFIX = "bench."
WINDOW_SPAN = "traced_window"  # the traced stretch: a gap in no other span reads so


def load_benchmark(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with everything it names, loaded."""

    name: str
    workload: dict
    config: dict           # the configuration's file, as run
    config_entry: dict     # its entry in BENCHMARK.json
    traffic: dict          # the traffic mix's file
    end_to_end: list       # the metrics this cell reports with --trace 0
    per_layer: list        # ... with --trace 1


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[dict] = None, root: Path = ROOT) -> Cell:
    """The cell called ``name``, its configuration, traffic and metrics."""
    bench = bench if bench is not None else load_benchmark(root / "BENCHMARK.json")
    found = [w for w in bench["workloads"] if w["name"] == name]
    if not found:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in bench['workloads']]}")
    workload = found[0]
    entry = next(c for c in bench["configs"] if c["name"] == workload["config"])
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(root / "bench_port" / "traffic" / f"{workload['traffic']}.json") as f:
        traffic = json.load(f)
    return Cell(name, workload, config, entry, traffic,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_file(name: str) -> Path:
    """``metrics/<name>.py``, or else the family's ``metrics/<prefix>.py``
    (the name up to its last dot)."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    if own.is_file() or "." not in name:
        return own
    return BENCH_DIR / "metrics" / f"{name.rsplit('.', 1)[0]}.py"


def metric_reader(name: str) -> Callable:
    """The ``read`` of ``metric_file(name)`` (a metric's name may hold dots,
    so the file is loaded by its path, as a module of ``bench_port.metrics``)."""
    import importlib.util

    path = metric_file(name)
    module = "bench_port.metrics._" + "".join(c if c.isalnum() else "_" for c in path.stem)
    if module not in sys.modules:
        importlib.import_module("bench_port.metrics")
        spec = importlib.util.spec_from_file_location(module, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[module] = mod
        spec.loader.exec_module(mod)
    return sys.modules[module].read


def driver(cell: Cell):
    return importlib.import_module(f"bench_port.drivers.{cell.traffic['driver']}")


@dataclasses.dataclass
class Check:
    """One number compared with the plain reference, and its limit: the
    run is correct where every ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return bool(self.value <= self.limit) and not math.isnan(self.value)


@dataclasses.dataclass
class Context:
    """What a driver's ``setup`` gets: the cell, the seed, the device, and
    ``small``: sizes that tests put in the place of the cell's (None on a
    benchmark run)."""

    cell: Cell
    seed: int
    device: object
    small: Optional[dict] = None
    phases: list = dataclasses.field(default_factory=list)

    def mark(self, phase: str) -> None:
        """Note that the set-up's ``phase`` has ended (printed on stderr)."""
        self.phases.append((phase, time.perf_counter()))


# ------------------------------------------------------------------ tracing

def span(name: str):
    """A host span of the benchmark's own code around a call into a layer
    (``torch.profiler.record_function``; recorded only while a trace runs)."""
    import torch

    return torch.profiler.record_function(SPAN_PREFIX + name)


def union(intervals) -> list:
    """Sorted, merged (start, end) intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def summarize_trace(events, window_us: tuple) -> dict:
    """torch.profiler events of a traced window -> the record's ``trace``:
    the device's busy seconds (the union of its kernels', memcpys' and
    memsets' intervals), the window's seconds, each device operation's
    launches and summed seconds, and the idle gaps, each labelled with the
    benchmark's host span that was open at the gap's middle."""
    from torch.autograd import DeviceType

    t0, t1 = window_us
    dev, spans = [], []
    for e in events:
        a, b = e.time_range.start, e.time_range.end
        if e.name.startswith(SPAN_PREFIX):
            if e.device_type == DeviceType.CPU:
                spans.append((a, b, e.name[len(SPAN_PREFIX):]))
            continue  # a span's range shows on the device's timeline too
        if e.device_type == DeviceType.CUDA and b > t0 and a < t1:
            dev.append((max(a, t0), min(b, t1), e.name))
    busy = union((a, b) for a, b, _ in dev)
    ops: dict = {}
    for a, b, name in dev:
        n, s = ops.get(name, (0, 0.0))
        ops[name] = (n + 1, s + (b - a) / 1e6)
    edges = [t0] + [x for ab in busy for x in ab] + [t1]
    gaps = []
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            mid = (a + b) / 2
            open_ = [s for s in spans if s[0] <= mid <= s[1]]
            label = min(open_, key=lambda s: s[1] - s[0])[2] if open_ else "outside_spans"
            gaps.append((label, (b - a) / 1e6))
    return {"busy_s": sum(b - a for a, b in busy) / 1e6, "window_s": (t1 - t0) / 1e6,
            "ops": ops, "gaps": gaps}


class Tracer:
    """torch.profiler over a stretch of ``seconds`` that a driver runs after
    its window has closed, with the same load: the window's own numbers
    stay untraced. ``start()``, then ``with stretch():`` around the traced
    load, then ``stop()``; the trace is read once the load has stopped
    (``summarize``), within the stretch."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.prof = None

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.__enter__()

    def stretch(self):
        """The traced stretch: a span that ``summarize`` takes as its window."""
        return span(WINDOW_SPAN)

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)

    def summarize(self) -> Optional[dict]:
        if self.prof is None:
            return None
        events = self.prof.events()
        whole = [e for e in events if e.name == SPAN_PREFIX + WINDOW_SPAN]
        return summarize_trace(events, (whole[0].time_range.start, whole[0].time_range.end))


def run_for(seconds: float, body: Callable[[], None]) -> tuple:
    """``body()`` over and over until ``seconds`` have passed on the host
    clock -> (calls, the seconds it took)."""
    t0 = time.perf_counter()
    calls = 0
    while time.perf_counter() < t0 + seconds:
        body()
        calls += 1
    return calls, time.perf_counter() - t0


# ------------------------------------------------------------------- result

def device_info(count: int, memory_peak_bytes: int) -> dict:
    import torch

    limit = None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        limit = out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        pass
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count,
            "memory_peak_bytes": int(memory_peak_bytes), "power_limit": limit}


def breakdown(trace: dict) -> dict:
    ops = sorted(((name, s) for name, (_, s) in trace["ops"].items()), key=lambda t: -t[1])
    by_label: dict = {}
    for label, s in sorted(trace["gaps"], key=lambda g: -g[1])[:10]:
        by_label[label] = by_label.get(label, 0.0) + s
    gaps = sorted(by_label.items(), key=lambda t: -t[1])
    return {"device_ops": [[n, s] for n, s in ops[:10]],
            "idle_gaps": [[n, s] for n, s in gaps[:10]]}


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result_line(cell: Cell, record: dict, checks: list, trace: bool, device: dict) -> dict:
    """The last line of standard output (its keys in the contract's order,
    ``checks`` last)."""
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    out = {"correct": all(c.ok for c in checks) and bool(checks),
           "attempted": int(record["attempted"]), "failed": int(record["failed"]),
           "metrics": metrics, "device": device}
    if trace and record.get("trace"):
        out["device"] = dict(device, busy_s=record["trace"]["busy_s"],
                             window_s=record["trace"]["window_s"])
        out["breakdown"] = breakdown(record["trace"])
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             small: Optional[dict] = None) -> tuple:
    """Set-up, the window, the comparison -> (record, checks). ``t_start``:
    the process's start on the host clock (set-up counts from it)."""
    import torch

    ctx = Context(cell, seed, device, small)
    ctx.mark("imports")
    bench = driver(cell).setup(ctx)
    try:
        tracer = Tracer(cell.traffic["trace_seconds"]) if trace else None
        setup_s = time.perf_counter() - t_start
        last = t_start
        for phase, t in ctx.phases:
            print(f"setup {phase}: {t - last:.3f} s", file=sys.stderr)
            last = t
        record = bench.window(seconds, tracer)
        t = time.perf_counter()
        if tracer is not None:
            record["trace"] = tracer.summarize()
            print(f"trace read in {time.perf_counter() - t:.3f} s", file=sys.stderr)
        record["setup_s"] = setup_s
        # the peak before the reference runs on the card (a peak never falls)
        record["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                       if device.type == "cuda" else 0)
        t = time.perf_counter()
        checks = bench.check()
        print(f"comparison in {time.perf_counter() - t:.3f} s", file=sys.stderr)
    finally:
        bench.close()
    return record, checks


def main(argv=None, t_start: Optional[float] = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"bench_port: the cell needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    record, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), t_start)
    bad = loaded_forbidden()
    if bad:
        print(f"bench_port: modules of {bad} were loaded in the measuring process",
              file=sys.stderr)
        return 3
    device = device_info(chips, record["memory_peak_bytes"])
    line = result_line(cell, record, checks, bool(args.trace), device)
    for c in checks:
        print(f"check {c.name}: {c.value!r} (limit {c.limit!r}) "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
