"""The port's program spans on the card (utils/profiling.py, ops/graphs.py):
a small MoE train step (uit_xs_moe at depth 2, B=8 x 1 s int16, AdamW,
the exact mel kernel) captured as a CUDA graph with its spans' marks, its
nodes listed by libcuda, and three replays traced.

- Every replayed kernel, memcpy and memset matches its graph node by name
  (``spans_matched`` 1.0), and the top-level spans plus ``unspanned`` sum
  to the replays' device busy time within 1 %.
- The marks add no node: the graph captured without them has the same
  nodes, kind and name, one for one.
- No span casts a range onto the device's timeline, eager or replayed.
- Eager under the profiler, the backward's span, opened and closed by
  hooks on autograd's device thread, lies inside ``uit.backward`` once a
  block.
- Two runs of the step from one seed and one state end on bitwise-equal
  parameters, and so does a run of eager steps.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_spans_gpu.py -q
"""

import contextlib
import ctypes

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops.graphs import calls_to_capture
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.parallel import make_moe_train_step
from uit_mobile_tpu_torch.train import build_optimizer
from uit_mobile_tpu_torch.utils import profiling
from uit_mobile_tpu_torch.utils.profiling import graph_span_ms, top_spans

DEPTH, B, REPLAYS = 2, 8, 3
TOP = {"uit.frontend", "uit.moe.mlp", "uit.backward", "uit.optim.update"}
INNER = {"uit.moe.route", "uit.moe.dispatch", "uit.moe.experts", "uit.moe.combine",
         "uit.moe.mlp.backward"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs and the mel kernel have no CPU mode")
    return torch.device("cuda")


def _step(cuda):
    cfg = models.get_model_config("uit_xs_moe", outputdim=37, target_length=102, depth=DEPTH)
    model = models.build(cfg, torch.Generator().manual_seed(0), "cpu").to(cuda).train()
    opt = build_optimizer("AdamW", 1e-3, weight_decay=5e-8).init(model)
    fe = make_frontend_fn(cfg.frontend, precision="exact", layout="bft")
    step = make_moe_train_step(cfg, model, opt, frontend_fn=fe)
    g = torch.Generator().manual_seed(1)
    wav = (torch.randn(B, 16000, generator=g) * 3000).to(torch.int16).to(cuda)
    target = (torch.rand(B, 37, generator=g) > 0.8).float().to(cuda)
    return step, wav, target


def _graphed(cuda):
    step, wav, target = _step(cuda)
    for _ in range(calls_to_capture(step)):
        step(wav, target)
    (g,) = step.graphs.graphs.values()
    return step, g, wav, target


def _node_count(g) -> int:
    """The captured graph's nodes, of every kind."""
    return profiling._node_count(profiling._libcuda(), ctypes.c_void_p(g.graph.raw_cuda_graph()))


def _traced(fn, n: int = REPLAYS):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    return prof.events()


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        total += max(0.0, b - max(a, end))
        end = max(end, b)
    return total


@pytest.mark.gpu
def test_replayed_ops_match_their_nodes_and_sum_to_busy(cuda):
    step, g, wav, target = _graphed(cuda)
    assert {m[0] for m in g.marks} == TOP | INNER
    assert all(m[2] is not None and m[1] <= m[2] <= _node_count(g) for m in g.marks)
    events = _traced(lambda: step(wav, target))
    ms, matched = graph_span_ms(events, step.graphs)
    assert matched == 1.0, ms
    assert top_spans(step.graphs) == TOP
    launched = {e.id for e in events
                if e.device_type == DeviceType.CPU and e.name.startswith("cudaGraphLaunch")}
    ops = [e for e in events if e.device_type == DeviceType.CUDA and e.id in launched
           and not e.is_user_annotation]
    assert len(ops) == REPLAYS * len(g.device_nodes())
    busy_ms = _union_us((e.time_range.start, e.time_range.end) for e in ops) / REPLAYS / 1e3
    total = sum(ms[s] for s in TOP) + ms["unspanned"]
    assert abs(total - busy_ms) <= 0.01 * busy_ms, (ms, busy_ms)
    for inner in ("uit.moe.route", "uit.moe.dispatch", "uit.moe.experts", "uit.moe.combine"):
        assert 0.0 < ms[inner] < ms["uit.moe.mlp"]
    assert 0.0 < ms["uit.moe.mlp.backward"] < ms["uit.backward"]
    assert not [e.name for e in events if e.name.startswith(profiling.SPAN_PREFIX)
                and e.device_type != DeviceType.CPU]


@pytest.mark.gpu
def test_marks_add_no_node(cuda, monkeypatch):
    _, marked, _, _ = _graphed(cuda)
    # the same capture with no stream registered for marks
    monkeypatch.setattr(profiling, "capture_marks",
                        lambda stream, marks: contextlib.nullcontext())
    _, plain, _, _ = _graphed(cuda)
    assert marked.marks and not plain.marks
    assert _node_count(marked) == _node_count(plain)
    assert ([(k, n) for _, k, n in marked.device_nodes()]
            == [(k, n) for _, k, n in plain.device_nodes()])


@pytest.mark.gpu
def test_eager_backward_span_on_the_device_thread(cuda):
    step, wav, target = _step(cuda)  # its first call runs eagerly
    events = _traced(lambda: step(wav, target), n=1)
    spans = [e for e in events if e.name.startswith(profiling.SPAN_PREFIX)]
    assert all(e.device_type == DeviceType.CPU for e in spans)
    (backward,) = [e.time_range for e in spans if e.name == "uit.backward"]
    inner = [e.time_range for e in spans if e.name == "uit.moe.mlp.backward"]
    assert len(inner) == DEPTH
    assert all(backward.start <= r.start and r.end <= backward.end for r in inner)
    assert sum(e.name == "uit.moe.mlp" for e in spans) == DEPTH


@pytest.mark.gpu
def test_moe_step_repeats_bitwise(cuda):
    """Two runs of the small MoE step from one seed and one starting state
    (each its eager first call, the capture, then replays: four steps) end
    with bitwise-equal parameters, the routed MLP's dispatch and combine
    being gathers with no atomic sum; a run of four eager steps ends on the
    same parameters."""

    def run(graphed):
        step, wav, target = _step(cuda)
        for _ in range(4):
            if graphed:
                step(wav, target)
            else:
                (kind,) = step.optimizer.plan(1)
                step.device_step({"wav": wav, "target": target}, None, kind,
                                 step.optimizer.scalars(1)[0])
        torch.cuda.synchronize()
        return [p.detach().clone() for p in step.optimizer.params]

    first, second, eager = run(True), run(True), run(False)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    assert all(torch.equal(a, b) for a, b in zip(first, eager))
