"""CUDA graphs of the port's programs: what ``jax.jit`` does for the JAX package.

Every program of the JAX package runs under ``jax.jit``: one serving
forward, one eval batch, one streaming hop and one fused train step are
each one dispatched XLA program, traced once per shape. ``graphed(fn,
device)`` gives the port the same on the card: one ``torch.cuda.CUDAGraph``
per key (the shapes and dtypes of the tensor arguments, the values of the
others), replayed with one host call.

- The first ``WARMUP`` calls of a key run ``fn`` eagerly on a side stream,
  as the CUDA-graph docs ask before a capture; they are real calls, whose
  results and side effects are the caller's. The next call captures ``fn``
  and replays the graph; later calls only replay it.
- The tensor arguments are copied into static buffers (``copy_``, from any
  device); ``fn`` always reads those. Tensor outputs are cloned out of the
  graph's static outputs, so a caller may keep them across calls; any other
  output must depend on the key alone (it is kept from the capture).
- Every ``torch.Generator`` argument on the card is registered with the
  graph (``CUDAGraph.register_generator_state``): each replay advances it
  exactly as the eager call would. A CUDA generator that ``fn`` reaches
  another way makes the capture raise.
- All graphs on a card share one memory pool and one side stream, on
  which every warm-up and capture runs (one at a time), so that memory a
  capture frees is there for the next. Replays are ordered on the device
  by one event, and each clones its outputs before the next replay starts:
  graphs replayed from two streams never overlap in the pool.
- The mel kernel's launch counters (``ops/mel.py:launches``) count kernel
  executions: a capture records its launches apart (nothing runs then),
  and each replay adds them to the counters.
- The program's spans (``utils/profiling.py:span``) that run inside a
  capture leave their marks on the graph (``_Graph.marks``: name, node
  count at enter and at exit), and the graph's own ``cudaGraph_t`` is kept
  (``keep_graph``) to be listed at the first ask (``_Graph.device_nodes``):
  ``profiling.graph_span_ms`` reads both against a trace of replays. A
  replay runs inside the spans ``uit.graph.stage`` (the input copies),
  ``uit.graph.replay`` (the fence and the launch) and ``uit.graph.outputs``
  (the clones and the fence after them).
- A failed capture raises. Nothing falls back to eager at run time. With
  ``agree`` (a program of several ranks whose collectives the graph holds:
  ``parallel.collectives.capture_agreement``) the ranks exchange whether
  each captured before the first replay, and a capture that failed on any
  rank raises on every rank.

On a CPU device ``graphed`` returns ``fn`` itself: the eager path the
caller asked for.

Capture runs with ``capture_error_mode="thread_local"``: other threads (the
training loader's ``device_prefetch`` thread, a service's worker while a
reload captures) may go on using the card meanwhile; their work is not
captured.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import torch
from torch.utils import _pytree as pytree

from ..utils import profiling
from . import mel as _mel

# eager calls of a key before its capture
WARMUP = 1

_cards: dict = {}  # device -> _Card
_cards_lock = threading.Lock()


class _Card:
    """A card's share of the graphs: its memory pool, held by a graph that
    lives as long as the process (the allocator releases a pool whose last
    graph is freed, and a released pool cannot be captured into again: a
    service's reload or a dropped Evaluator would free the last); the side
    stream of every warm-up and capture, under ``side_lock``; and the event
    after the last replay, under ``replay_lock``."""

    def __init__(self, device: torch.device):
        self.pool = torch.cuda.graph_pool_handle()
        self.side = torch.cuda.Stream(device)
        self.side_lock = threading.RLock()
        self.replay_lock = threading.Lock()
        self.fence = None
        self.keeper = torch.cuda.CUDAGraph()
        cur = torch.cuda.current_stream(device)
        self.side.wait_stream(cur)
        with torch.cuda.stream(self.side):
            self.keeper.capture_begin(pool=self.pool, capture_error_mode="thread_local")
            self.held = torch.zeros(1, device=device)
            self.keeper.capture_end()
        cur.wait_stream(self.side)


def _card(device: torch.device) -> _Card:
    with _cards_lock:
        if device not in _cards:
            _cards[device] = _Card(device)
        return _cards[device]


def _leaf_key(x):
    if isinstance(x, torch.Tensor):
        return ("T", tuple(x.shape), x.dtype)
    if isinstance(x, torch.Generator):
        return ("G", x)  # the object itself: its id is never reused while the key lives
    return ("S", x)


class _Graph:
    """One captured graph and its static buffers."""

    def __init__(self):
        self.graph = torch.cuda.CUDAGraph(keep_graph=True)
        self.marks: list = []    # the spans' capture marks: [name, enter, exit]
        self._nodes = None       # profiling.graph_nodes of the graph, once asked
        self.inputs: list = []   # static input leaves (tensors the graph reads)
        self.outputs: list = []  # static output leaves
        self.out_spec = None
        self.launches: dict = {}  # mel kernel launches a replay, by variant
        self.capture_s = 0.0
        self.pool_bytes = 0
        self.replays = 0

    def device_nodes(self) -> list:
        """[(position, kind, name)] of the graph's kernel, memcpy and memset
        nodes (``profiling.graph_nodes``), listed at the first ask."""
        if self._nodes is None:
            self._nodes = profiling.graph_nodes(self.graph.raw_cuda_graph())
        return self._nodes


class GraphedFn:
    """``fn`` on the card as CUDA-graph replays, one graph per key (module
    docstring). ``graphs`` maps each key to its ``_Graph``; ``stats()``
    summarizes them."""

    def __init__(self, fn: Callable, device: torch.device,
                 agree: Optional[Callable[[bool], bool]] = None):
        self.fn = fn
        self.device = _indexed(torch.device(device))
        self.agree = agree
        self.graphs: dict = {}
        self._eager_calls: dict = {}
        self._lock = threading.Lock()

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        key = (spec, tuple(_leaf_key(x) for x in leaves))
        with self._lock:
            g = self.graphs.get(key)
            if g is None:
                n = self._eager_calls.get(key, 0)
                if n < WARMUP:
                    self._eager_calls[key] = n + 1
                    return self._eager(args)
                g = self._capture(key, leaves, spec)
            return self._replay(g, leaves)

    def _eager(self, args):
        card, cur = _card(self.device), torch.cuda.current_stream(self.device)
        with card.side_lock:
            card.side.wait_stream(cur)
            with torch.cuda.stream(card.side):
                out = self.fn(*args)
            cur.wait_stream(card.side)
        return out

    def _capture(self, key, leaves, spec) -> _Graph:
        g = _Graph()
        for x in leaves:
            if isinstance(x, torch.Tensor):
                buf = torch.empty(x.shape, dtype=x.dtype, device=self.device)
                buf.copy_(x)
                g.inputs.append(buf)
            else:
                if isinstance(x, torch.Generator) and x.device.type == "cuda":
                    g.graph.register_generator_state(x)
                g.inputs.append(x)
        args = pytree.tree_unflatten(g.inputs, spec)
        card, cur = _card(self.device), torch.cuda.current_stream(self.device)
        failed = None
        with card.side_lock:
            card.side.wait_stream(cur)
            reserved = torch.cuda.memory_reserved(self.device)
            _mel.capture.launches = g.launches = dict.fromkeys(_mel.launches, 0)
            t0 = time.perf_counter()
            try:
                with torch.cuda.stream(card.side):
                    g.graph.capture_begin(pool=card.pool, capture_error_mode="thread_local")
                    try:
                        with profiling.capture_marks(card.side, g.marks):
                            out = self.fn(*args)
                    except BaseException:
                        try:
                            g.graph.capture_end()
                        except RuntimeError:
                            pass  # the capture was already invalid; the first error says why
                        raise
                    g.graph.capture_end()
                    g.graph.instantiate()
            except Exception as e:  # noqa: BLE001 - raised below, on every rank with agree
                failed = e
            finally:
                _mel.capture.launches = None
            cur.wait_stream(card.side)
        agreed = self.agree is None or self.agree(failed is None)
        if failed is not None:
            raise failed
        if not agreed:
            raise RuntimeError("another rank's capture of this key failed (its own error "
                               "says why); no rank replays it")
        g.capture_s = time.perf_counter() - t0
        g.pool_bytes = torch.cuda.memory_reserved(self.device) - reserved
        g.outputs, g.out_spec = pytree.tree_flatten(out)
        self.graphs[key] = g
        return g

    def _replay(self, g: _Graph, leaves):
        with profiling.span("graph.stage"):
            for buf, x in zip(g.inputs, leaves):
                if isinstance(buf, torch.Tensor) and buf is not x:
                    buf.copy_(x)
        card, cur = _card(self.device), torch.cuda.current_stream(self.device)
        with card.replay_lock:  # one pool: replays never overlap on the device
            with profiling.span("graph.replay"):
                if card.fence is not None:
                    cur.wait_event(card.fence)
                g.graph.replay()
            with profiling.span("graph.outputs"):
                # out of the pool before another graph's replay may reuse it
                out = [x.clone() if isinstance(x, torch.Tensor) else x for x in g.outputs]
                card.fence = torch.cuda.Event()
                card.fence.record(cur)
        g.replays += 1
        with _mel._launches_lock:
            for k, v in g.launches.items():
                _mel.launches[k] += v
        return pytree.tree_unflatten(out, g.out_spec)

    def summary(self) -> dict:
        """Keys seen, graphs captured, calls and replays so far (calls =
        the eager warm-ups and the replays: a key's capture replays it)."""
        replays = sum(g.replays for g in self.graphs.values())
        return {"keys": len(self._eager_calls), "graphs": len(self.graphs),
                "calls": sum(self._eager_calls.values()) + replays, "replays": replays}

    def stats(self) -> list[dict]:
        """Per captured key: capture seconds, pool growth in bytes, mel
        kernel launches a replay, replays so far."""
        return [{"capture_s": g.capture_s, "pool_bytes": g.pool_bytes,
                 "launches": {k: v for k, v in g.launches.items() if v},
                 "replays": g.replays} for g in self.graphs.values()]


def _indexed(device: torch.device) -> torch.device:
    """'cuda' -> 'cuda:<current>': one key for the pool and fence of a card."""
    if device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def graphed(fn: Callable, device, agree: Optional[Callable[[bool], bool]] = None) -> Callable:
    """``fn`` as CUDA-graph replays on a CUDA ``device``; ``fn`` itself on the
    CPU (module docstring). ``agree``: the ranks' agreement on each
    capture, for a program whose graph holds collectives."""
    device = torch.device(device)
    return GraphedFn(fn, device, agree) if device.type == "cuda" else fn


def graphed_forward(body: Callable, device, agree: Optional[Callable[[bool], bool]] = None,
                    capture: bool = True) -> Callable:
    """A forward ``fn(wav)``: ``body`` on the batch moved to ``device``, under
    inference mode, through ``graphed`` (``agree`` as there); with
    ``capture`` False ``body`` runs eagerly (a program whose collectives no
    graph may hold). ``fn.eager`` is fn never graphed (fn itself when
    eager), ``fn.graphs`` the ``GraphedFn`` (None when eager):
    ``calls_to_capture``, the dispatch summaries and the data-parallel
    replicas read these two."""
    run = graphed(body, device, agree) if capture else body

    def on_device(call):
        @torch.inference_mode()
        def fn(wav):
            return call(torch.as_tensor(wav).to(device))

        return fn

    fn = on_device(run)
    fn.eager, fn.graphs = (fn, None) if run is body else (on_device(body), run)
    return fn


def calls_to_capture(fn) -> int:
    """How many calls of a new key ``fn`` takes to hold its graph (the
    warm-up calls and the one that captures): ``fn`` may be a ``GraphedFn``,
    a function with one as its ``graphs`` attribute (``graphed_forward``'s
    forwards, the train steps) or one whose ``replicas`` each call theirs
    (``parallel.mesh.data_parallel_forward``: the most any replica takes);
    1 for an eager function."""
    replicas = getattr(fn, "replicas", None)
    if replicas is not None:
        return max(calls_to_capture(r) for r in replicas)
    g: Optional[GraphedFn] = fn if isinstance(fn, GraphedFn) else getattr(fn, "graphs", None)
    return 1 if g is None else WARMUP + 1
