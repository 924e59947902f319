"""The port's program spans and their attribution (utils/profiling.py) on
the CPU: ``span`` records nothing without a profiler or a capture; under
torch.profiler a depth-2 MoE train step's spans nest as the step runs
them (the routed MLP's four parts inside ``uit.moe.mlp`` once a block,
``uit.moe.mlp.backward`` once a block inside ``uit.backward``), as
function-scope ranges that cast nothing onto a device's timeline; the
same step under a capture stand-in leaves the same nesting as capture
marks; and ``graph_span_ms`` reads a synthetic graph's nodes and marks
against a synthetic trace of its replays.

The card's side (a real capture, its nodes listed by libcuda, replays
traced) is tests/test_torch_spans_gpu.py."""

import itertools
import types

import pytest
import torch
from torch.autograd import DeviceType
from torch.autograd.profiler_util import FunctionEvent
from torch.profiler import ProfilerActivity, profile

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.models import moe
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.parallel import make_moe_train_step
from uit_mobile_tpu_torch.train import build_optimizer
from uit_mobile_tpu_torch.utils import profiling
from uit_mobile_tpu_torch.utils.profiling import graph_span_ms, same_op, span, top_spans

torch.set_num_threads(1)

DEPTH = 2
MLP_PARTS = ("uit.moe.route", "uit.moe.dispatch", "uit.moe.experts", "uit.moe.combine")


def _step():
    cfg = models.get_model_config("uit_xs_moe", outputdim=37, target_length=102,
                                  depth=DEPTH, n_experts=4)
    model = models.build(cfg, torch.Generator().manual_seed(0), "cpu").train()
    opt = build_optimizer("AdamW", 1e-3).init(model)
    fe = make_frontend_fn(cfg.frontend, precision="exact", layout="bft")
    step = make_moe_train_step(cfg, model, opt, frontend_fn=fe)
    g = torch.Generator().manual_seed(1)
    wav = torch.randn(2, 16000, generator=g) * 0.1
    target = (torch.rand(2, 37, generator=g) > 0.8).float()
    return cfg, model, step, wav, target


@pytest.fixture(scope="module")
def moe_step():
    return _step()


def _inside(inner, outer) -> bool:
    return outer[0] <= inner[0] and inner[1] <= outer[1]


def _ranges(spans, name):
    return [(a, b) for n, a, b in spans if n == name]


def _check_nesting(spans):
    """[(name, start, end)] of one MoE step -> the nesting the step runs."""
    count = {n: len(_ranges(spans, n)) for n, _, _ in spans}
    assert count["uit.moe.mlp"] == DEPTH and count["uit.moe.mlp.backward"] == DEPTH
    assert count["uit.backward"] == 1 and count["uit.optim.update"] == 1
    assert count["uit.frontend"] == 1
    mlps, backward = _ranges(spans, "uit.moe.mlp"), _ranges(spans, "uit.backward")[0]
    for part in MLP_PARTS:
        ranges = _ranges(spans, part)
        assert len(ranges) == DEPTH
        # one of each part inside each block's MLP, none outside
        assert [sum(_inside(r, m) for r in ranges) for m in mlps] == [1] * DEPTH
    for r in _ranges(spans, "uit.moe.mlp.backward"):
        assert _inside(r, backward)
    for m in mlps:
        assert not _inside(m, backward) and m[1] <= backward[0]
    frontend = _ranges(spans, "uit.frontend")[0]
    assert frontend[1] <= mlps[0][0]
    assert backward[1] <= _ranges(spans, "uit.optim.update")[0][0]


def test_span_records_nothing_without_a_profiler_or_a_capture():
    assert not profiling.spanning()
    assert span("anything") is profiling._NULL
    with span("anything") as s:
        assert s is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.spanning()
        with span("traced"):
            torch.ones(3).sum()
    names = [e.name for e in prof.events()]
    assert names.count("uit.traced") == 1 and "uit.anything" not in names
    assert span("later") is profiling._NULL


def test_spans_are_function_ranges():
    """A user annotation (record_function) gets a copy on the device's
    timeline under a CUDA trace; a span is a function range, as an ATen
    op's, and gets none: the profiler marks it not a user annotation."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("fn"):
            pass
        with torch.profiler.record_function("user"):
            pass
    ev = {e.name: e for e in prof.events()}
    assert not ev["uit.fn"].is_user_annotation and ev["user"].is_user_annotation


def test_moe_step_spans_nest_under_the_profiler(moe_step):
    cfg, model, step, wav, target = moe_step
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = step(wav, target)
    assert torch.isfinite(out["total_loss"])
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
             if e.name.startswith(profiling.SPAN_PREFIX)]
    _check_nesting(spans)
    assert len(_ranges(spans, "uit.step.plan")) == 1
    assert all(e.device_type == DeviceType.CPU for e in prof.events()
               if e.name.startswith(profiling.SPAN_PREFIX))


def test_moe_step_leaves_the_same_nesting_as_capture_marks(moe_step, monkeypatch):
    """A capture stand-in around the step's device side, as a graph holds
    it (the host plans the micro-step before): the current stream's handle
    is registered (``capture_marks``) and its graph's node count is a
    counter that every query advances. The marks nest as the profiler's
    ranges do; outside the capture the step leaves none."""
    cfg, model, step, wav, target = moe_step
    stream = types.SimpleNamespace(cuda_stream=7)
    nodes = itertools.count()
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(profiling, "capture_position", lambda *a: next(nodes))

    def device_side():
        (kind,) = step.optimizer.plan(1)
        step.device_step({"wav": wav, "target": target}, None, kind,
                         step.optimizer.scalars(1)[0])

    marks: list = []
    with profiling.capture_marks(stream, marks):
        assert profiling.spanning()
        device_side()
    assert not profiling.spanning() and all(m[2] is not None for m in marks)
    _check_nesting(marks)
    assert top_spans([types.SimpleNamespace(marks=marks)]) == {
        "uit.frontend", "uit.moe.mlp", "uit.backward", "uit.optim.update"}
    n = len(marks)
    device_side()
    assert len(marks) == n


def test_backward_hooks_only_while_spanning(moe_step):
    cfg, model, _, wav, _ = moe_step
    x = torch.randn(2, 12, cfg.base.embed_dim, requires_grad=True)
    y, aux = moe.moe_mlp(cfg, model.blocks[0].moe, x)
    assert not y._backward_hooks and not x._backward_hooks
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        y, aux = moe.moe_mlp(cfg, model.blocks[0].moe, x)
        assert y._backward_hooks and aux._backward_hooks
        torch.autograd.grad(y.square().sum() + aux, [x])
    backward = [e for e in prof.events() if e.name == "uit.moe.mlp.backward"]
    assert len(backward) == 1
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        y, _ = moe.moe_mlp(cfg, model.blocks[0].moe, x)
    assert not y._backward_hooks


# ------------------------------------------------ graph_span_ms, synthetic

# a graph of 6 nodes: 5 on the device and, at position 2, an event record
# (graph_nodes names a kernel node by its demangled symbol, as the profiler does)
TRACED = ["void at::native::elementwise_kernel<128, 2>(int)", "Memset (Device)",
          "gemm_kernel", "Memcpy DtoD (Device -> Device)",
          "void at::native::(anonymous namespace)::reduce_kernel<512>()"]
NODES = [(0, "kernel", TRACED[0]), (1, "memset", None), (3, "kernel", TRACED[2]),
         (4, "memcpy", None), (5, "kernel", TRACED[4])]
US = [10.0, 2.0, 30.0, 4.0, 6.0]
# 'uit.a' holds nodes 0-4, 'uit.b' node 3, 'uit.c' none, 'uit.open' never closed
MARKS = [["uit.a", 0, 5], ["uit.b", 3, 4], ["uit.c", 5, 5], ["uit.open", 5, None]]


def _graph():
    return types.SimpleNamespace(marks=MARKS, device_nodes=lambda: NODES)


class _Trace:
    def __init__(self):
        self.events, self.t, self.ids = [], 0.0, itertools.count(100)

    def add(self, name, us, device=True, cid=None, **kw):
        cid = next(self.ids) if cid is None else cid
        self.events.append(FunctionEvent(cid, name, 1, self.t, self.t + us,
                                         device_type=DeviceType.CUDA if device
                                         else DeviceType.CPU, **kw))
        self.t += us + 1.0
        return cid

    def replay(self, ops, names=TRACED):
        cid = self.add("cudaGraphLaunch", 3.0, device=False)
        for i in ops:
            self.add(names[i], US[i], cid=cid)
        # a user annotation's copy on the device timeline, under the same id
        self.add("bench.step", 1.0, cid=cid, is_user_annotation=True)


def test_graph_span_ms_reads_whole_replays():
    tr = _Trace()
    tr.replay([3, 4])                      # cut by the stretch's start
    tr.add("aten::mm", 5.0, device=False, cid=tr.events[-1].id + 1)
    eager = tr.add("cudaLaunchKernel", 2.0, device=False)
    tr.add("gemm_kernel", 50.0, cid=eager)  # a kernel outside any graph
    tr.replay(range(5))
    wrong = list(TRACED)
    wrong[4] = "void other_kernel<512>()"  # the last node named otherwise
    tr.replay(range(5), wrong)
    tr.replay([0])                         # cut by the stretch's end
    ms, matched = graph_span_ms(tr.events, [_graph()])
    assert ms == pytest.approx({"uit.a": 0.046, "uit.b": 0.030, "unspanned": 0.006})
    assert matched == pytest.approx((2 * sum(US) - US[4]) / (2 * sum(US)))
    # the top-level spans and 'unspanned' hold every op once
    assert ms["uit.a"] + ms["unspanned"] == pytest.approx(sum(US) / 1e3)
    assert top_spans([_graph()]) == {"uit.a"}


def test_graph_span_ms_counts_a_short_replay_between_others_unmatched():
    tr = _Trace()
    tr.replay(range(5))
    tr.replay(range(4))  # not at an edge: a fault, not a cut
    tr.replay(range(5))
    ms, matched = graph_span_ms(tr.events, types.SimpleNamespace(graphs={"key": _graph()}))
    assert ms["uit.a"] == pytest.approx(0.046)
    assert matched == pytest.approx(2 * sum(US) / (2 * sum(US) + sum(US[:4])))
    assert graph_span_ms([], [_graph()]) == ({}, 0.0)


ELEMENTWISE = ("void at::native::elementwise_kernel<128, 4, at::native::{}>(int, {})")


@pytest.mark.parametrize("kind, name, traced, same", [
    ("kernel", ELEMENTWISE.format("AddFunctor", "float"), ELEMENTWISE.format("AddFunctor", "float"),
     True),
    # the same template, another functor or another type: another kernel
    ("kernel", ELEMENTWISE.format("AddFunctor", "float"), ELEMENTWISE.format("MulFunctor", "float"),
     False),
    ("kernel", ELEMENTWISE.format("AddFunctor", "float"), ELEMENTWISE.format("AddFunctor", "half"),
     False),
    ("kernel", "void at::native::reduce_kernel<4>()", "void at::native::reduce_kernel_v2<4>()",
     False),
    ("kernel", "mel_kernel(float const*, float*)", "mel_kernel(float const*, float*)", True),
    ("kernel", "nvjet_tst_64x8", "nvjet_tst_64x8", True),
    ("kernel", None, "nvjet_tst_64x8", False),
    ("memcpy", None, "Memcpy DtoD (Device -> Device)", True),
    ("memcpy", None, "memcpy32_post", True),
    ("memset", None, "Memset (Device)", True),
    ("memset", None, "Memcpy DtoD (Device -> Device)", False),
])
def test_same_op(kind, name, traced, same):
    assert same_op(kind, name, traced) is same
