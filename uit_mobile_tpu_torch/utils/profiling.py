"""Profiling and tracing hooks, counterpart of ``uit_mobile_tpu/utils/profiling.py``.

Usage:
    with trace("profiles/run1"):               # chrome://tracing or Perfetto
        fwd(batch)

    with step_timer(batch) as t:                # CUDA events for a CUDA tensor
        fwd(batch)
    t.elapsed_ms

    device_dispatch_ms("profiles/run1")         # device ms per dispatch

    with span("moe.route"):                     # a program span, 'uit.moe.route'
        ...
    graph_span_ms(prof.events(), step.graphs)   # device ms a replay, by span

Program spans. ``span(name)`` is a torch.profiler range named
``uit.<name>`` (``SPAN_PREFIX``) while a profiler runs, and a null context
after one flag check otherwise. It is a function-scope range
(``_RecordFunctionFast``), as an ATen op's is: unlike a
``record_function`` user annotation it casts no range onto the device's
timeline, so a trace's device time holds kernels, memcpys and memsets
alone. While ``ops/graphs.py`` captures a CUDA graph on the current
stream, a span also records a capture mark on that graph: its name and
the graph's node count at enter and at exit (``capture_position``). A mark
adds no node. Inside a replay no Python runs, so the marks are what ties
a replayed kernel to the layer that launched it: ``graph_span_ms`` reads
them against a trace of replays.
"""

from __future__ import annotations

import contextlib
import ctypes
import glob
import gzip
import json
import os
import time
from collections import defaultdict
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


# ------------------------------------------------------------ program spans

SPAN_PREFIX = "uit."
# stream handle -> the marks of the graph being captured on it (capture_marks)
_capturing: dict = {}
_NULL = contextlib.nullcontext()


def spanning() -> bool:
    """Whether a span records anything now: a profiler runs, or a graph
    capture takes marks."""
    return _autograd_profiler._is_profiler_enabled or bool(_capturing)


def span(name: str):
    """The program's span ``uit.<name>`` around a block (module docstring):
    a profiler range while one runs, a capture mark on the graph that the
    current stream captures into, else a null context."""
    if not (_autograd_profiler._is_profiler_enabled or _capturing):
        return _NULL
    return _Span(SPAN_PREFIX + name)


class _Span:
    """One span's profiler range and capture mark. A ``with`` enters and
    leaves it; ``open`` and ``close`` do the same apart (from autograd
    hooks), on one thread."""

    __slots__ = ("name", "_range", "_mark")

    def __init__(self, name: str):
        self.name, self._range, self._mark = name, None, None

    def open(self) -> None:
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        # the backward's hooks run on autograd's device thread, whose current
        # stream is the capturing one: a thread-local would not reach them
        marks = _capturing.get(torch.cuda.current_stream().cuda_stream) if _capturing else None
        if marks is not None:
            self._mark = [self.name, capture_position(), None]
            marks.append(self._mark)

    def close(self) -> None:
        if self._mark is not None:
            self._mark[2] = capture_position()
        if self._range is not None:
            self._range.__exit__(None, None, None)

    def __enter__(self):
        self.open()
        return self

    def __exit__(self, *exc):
        self.close()
        return False


@contextlib.contextmanager
def capture_marks(stream: "torch.cuda.Stream", marks: list):
    """Spans on ``stream`` append their marks ``[name, enter, exit]`` to
    ``marks`` (positions: the graph's node count) while the block runs:
    ``ops/graphs.py`` holds this around the function it captures."""
    _capturing[stream.cuda_stream] = marks
    try:
        yield
    finally:
        del _capturing[stream.cuda_stream]


# --------------------------------------------------- graphs through libcuda

_NODE_KINDS = {0: "kernel", 1: "memcpy", 2: "memset"}  # CUgraphNodeType
_KERN_OFFSET = 56  # CUDA_KERNEL_NODE_PARAMS_v2.kern: after func, 7 uints, 2 pointers
_lib = None


def _libcuda():
    """libcuda through ctypes, its graph queries typed, loaded at the first
    call (never where no card is)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL("libcuda.so.1")
        vp, name_out = ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p)
        lib.cuGraphGetNodes.argtypes = [vp, ctypes.POINTER(vp), ctypes.POINTER(ctypes.c_size_t)]
        lib.cuGraphNodeGetType.argtypes = [vp, ctypes.POINTER(ctypes.c_int)]
        lib.cuGetErrorName.argtypes = [ctypes.c_int, name_out]
        # (stream, status, capture id, graph, dependencies[, edge data], their count)
        out = [ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_ulonglong),
               ctypes.POINTER(vp), ctypes.POINTER(vp)]
        count = ctypes.POINTER(ctypes.c_size_t)
        lib.cuStreamGetCaptureInfo_v2.argtypes = [vp, *out, count]
        if hasattr(lib, "cuStreamGetCaptureInfo_v3"):  # CUDA 12.3 on
            lib.cuStreamGetCaptureInfo_v3.argtypes = [vp, *out, ctypes.POINTER(vp), count]
        for name in ("cuFuncGetName", "cuKernelGetName"):  # CUDA 12.3 on
            if hasattr(lib, name):
                getattr(lib, name).argtypes = [name_out, vp]
        if hasattr(lib, "cuGraphKernelNodeGetParams_v2"):
            lib.cuGraphKernelNodeGetParams_v2.argtypes = [vp, vp]
        _lib = lib
    return _lib


def _check(rc: int, what: str) -> None:
    if rc:
        err = ctypes.c_char_p()
        _libcuda().cuGetErrorName(rc, ctypes.byref(err))
        raise RuntimeError(f"{what} failed: {(err.value or b'?').decode()} ({rc})")


def _node_count(lib, graph: ctypes.c_void_p) -> int:
    n = ctypes.c_size_t(0)
    _check(lib.cuGraphGetNodes(graph, None, ctypes.byref(n)), "cuGraphGetNodes")
    return n.value


def capture_position() -> int:
    """The node count of the graph that the current stream is capturing
    into: ``cuStreamGetCaptureInfo``'s graph, read, never changed."""
    lib = _libcuda()
    s = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    status, cid, graph = ctypes.c_int(), ctypes.c_ulonglong(), ctypes.c_void_p()
    deps, edges, ndeps = ctypes.c_void_p(), ctypes.c_void_p(), ctypes.c_size_t()
    args = [ctypes.byref(x) for x in (status, cid, graph, deps)]
    if hasattr(lib, "cuStreamGetCaptureInfo_v3"):  # CUDA 12.3: edge data before the count
        rc = lib.cuStreamGetCaptureInfo_v3(s, *args, ctypes.byref(edges), ctypes.byref(ndeps))
    else:
        rc = lib.cuStreamGetCaptureInfo_v2(s, *args, ctypes.byref(ndeps))
    _check(rc, "cuStreamGetCaptureInfo")
    if status.value != 1:  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        raise RuntimeError("capture_position: the stream is not capturing")
    return _node_count(lib, graph)


def graph_nodes(graph: int) -> list:
    """A CUDA graph's kernel, memcpy and memset nodes (``graph``: a
    ``cudaGraph_t`` handle, as ``CUDAGraph.raw_cuda_graph()`` gives it) ->
    [(position, kind, name)] in the order the capture made them: position
    among all the graph's nodes, kind 'kernel', 'memcpy' or 'memset', name
    the kernel's symbol demangled as the profiler names its kernels (Kineto
    and ``torch._C._demangle`` both call ``abi::__cxa_demangle``), None for
    a copy or a set or where libcuda cannot name it."""
    lib = _libcuda()
    g = ctypes.c_void_p(graph)
    n = _node_count(lib, g)
    handles = (ctypes.c_void_p * n)()
    count = ctypes.c_size_t(n)
    _check(lib.cuGraphGetNodes(g, handles, ctypes.byref(count)), "cuGraphGetNodes")
    out = []
    for i, node in enumerate(handles[:count.value]):
        kind = ctypes.c_int()
        _check(lib.cuGraphNodeGetType(node, ctypes.byref(kind)), "cuGraphNodeGetType")
        if kind.value in _NODE_KINDS:
            name = _kernel_name(lib, node) if kind.value == 0 else None
            out.append((i, _NODE_KINDS[kind.value], name and torch._C._demangle(name)))
    return out


def _kernel_name(lib, node) -> Optional[str]:
    """A kernel node's symbol: its function's name, or its library kernel's
    (a lazily loaded kernel's node may hold the kernel alone)."""
    if not hasattr(lib, "cuGraphKernelNodeGetParams_v2"):
        return None
    params = (ctypes.c_char * 128)()  # CUDA_KERNEL_NODE_PARAMS_v2 is 72 bytes
    if lib.cuGraphKernelNodeGetParams_v2(node, params):
        return None
    name = ctypes.c_char_p()
    func = ctypes.c_void_p.from_buffer(params, 0).value
    kern = ctypes.c_void_p.from_buffer(params, _KERN_OFFSET).value
    if func and hasattr(lib, "cuFuncGetName") and not lib.cuFuncGetName(ctypes.byref(name), func):
        return name.value.decode(errors="replace")
    if kern and hasattr(lib, "cuKernelGetName") and not lib.cuKernelGetName(ctypes.byref(name),
                                                                            kern):
        return name.value.decode(errors="replace")
    return None


def same_op(kind: str, name: Optional[str], traced: str) -> bool:
    """Whether a traced device op's name (the profiler's) is a graph node
    of ``kind`` and ``name`` (``graph_nodes``): a kernel by its whole name,
    template arguments and parameters included. A memcpy node may replay as
    CUDA's own copy kernel ('memcpy32_post' on the H100)."""
    if kind != "kernel":
        return traced.lower().startswith(kind)
    return traced == name


# ------------------------------------------------ spans of replayed graphs

def _held(marks: list, position: int) -> tuple:
    """The names of the closed marks open around a node at ``position``."""
    return tuple(sorted({m[0] for m in marks if m[2] is not None
                         and m[1] <= position < m[2]}))


def top_spans(graphs) -> set:
    """The names of the marks that no other mark holds, over ``graphs``
    (a ``GraphedFn``, or its graphs)."""
    out = set()
    for g in _graph_list(graphs):
        closed = [m for m in g.marks if m[2] is not None]
        for i, (name, a, b) in enumerate(closed):
            if not any(c <= a and b <= d and (j < i or (c, d) != (a, b))
                       for j, (_, c, d) in enumerate(closed) if j != i):
                out.add(name)
    return out


def _graph_list(graphs) -> list:
    graphs = getattr(graphs, "graphs", graphs)
    return list(graphs.values()) if isinstance(graphs, dict) else list(graphs)


def graph_span_ms(events, graphs) -> tuple:
    """torch.profiler events of a stretch of replays of ``graphs`` (a
    ``GraphedFn``, or its ``_Graph``s) -> ({span: inclusive device ms a
    whole replay, and 'unspanned': the ms of the nodes that no mark
    holds}, the share of the replays' device time whose op matched its
    node by name).

    The kernels, memcpys and memsets of one replay are those correlated
    with one ``cudaGraphLaunch``. A replay whose count of them is no
    graph's count of such nodes is cut by the stretch's edge where it is
    the first or the last replay, and left out; elsewhere it counts as
    unmatched. A whole replay's ops, in the order they ran, are matched
    to the graph's nodes in the order the capture made them (a capture on
    one stream is a chain: its replay runs them in that order), each
    pair's names checked against each other (``same_op``), and each op's
    time goes to every mark open around its node (``_held``)."""
    from torch.autograd import DeviceType

    tables = []
    for g in _graph_list(graphs):
        nodes = g.device_nodes()
        tables.append([(kind, name, _held(g.marks, pos)) for pos, kind, name in nodes])
    launched = {e.id: e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cudaGraphLaunch")}
    replays: dict = defaultdict(list)
    for e in events:
        if (e.device_type == DeviceType.CUDA and e.id in launched
                and not getattr(e, "is_user_annotation", False)):
            replays[e.id].append(e)
    order = sorted(replays, key=launched.get)
    totals: dict = defaultdict(float)
    whole, matched, seen = 0, 0.0, 0.0
    for i, cid in enumerate(order):
        ops = sorted(replays[cid], key=lambda e: (e.time_range.start, e.time_range.end))
        us = [e.time_range.end - e.time_range.start for e in ops]
        fits = [t for t in tables if len(t) == len(ops)]
        if not fits:
            if i not in (0, len(order) - 1):
                seen += sum(us)
            continue
        hits = [[same_op(k, n, e.name) for (k, n, _), e in zip(t, ops)] for t in fits]
        best = max(range(len(fits)), key=lambda j: sum(d for d, h in zip(us, hits[j]) if h))
        whole += 1
        for (_, _, held), hit, d in zip(fits[best], hits[best], us):
            seen += d
            matched += d if hit else 0.0
            for name in held or ("unspanned",):
                totals[name] += d
    ms = {k: v / whole / 1e3 for k, v in sorted(totals.items())} if whole else {}
    return ms, (matched / seen if seen else 0.0)
