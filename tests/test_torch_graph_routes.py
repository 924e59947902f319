"""The dispatch of the port's multi-process and multi-replica programs on the
CPU: which routes take CUDA graphs on the card, and that the bodies a
capture would hold are capturable.

- The rule (``parallel.collectives.capturable``): a group is capturable iff
  its backend is NCCL; gloo and an in-process ``ThreadGroup`` are not
  (the backend faked with ``monkeypatch``). ``GridMesh.capturable`` asks it
  of every axis on the card; a train step is graphable on the card under
  NCCL ``rows``, on an FSDP placement's shards too (``train/steps.py:
  _graphable``); a trainer's validation replays under NCCL rows and runs
  its eager body under gloo rows.
- With the card's branch forced on the CPU (``_graphable`` or
  ``GridMesh.capturable`` true, ``graphed`` recording), every ``rows`` step
  (weak with mixup, SED, MAE, MoE) over a one-rank gloo group and every
  TP/SP/PP/EP forward hands its body to ``graphed`` with the ranks'
  capture agreement, the body calls no host read of a device value
  (``_local_scalar_dense``: a capture fails on it) and builds no ``Rows``
  after its first call, and its output is bitwise the eager route's (the
  step: the single-process step, as one rank gives it bit for bit). The
  FSDP and hybrid FSDP x TP steps (``make_train_step`` or the SED step on
  a placed model) too, their 'data' shards recorded over the one rank as a larger world
  records them: each call's body holds the step's one all-gather and one
  reduce-scatter, and equals the eager device side bitwise.
- ``capture_agreement`` over two gloo ranks (child processes, joined with
  a deadline): one rank's failed capture is every rank's.
- ``data_parallel_forward``: per-sample forwards run each replica's own
  (graphed) forward from the calling thread, with no ``ThreadGroup``,
  bitwise the threaded route; the 'torch' clamp and the MoE's routing keep
  the threads.

The four-rank forms of these routes are held in
tests/test_torch_model_parallel.py's world; the replays themselves on the
card in tests/test_torch_graphs_gpu.py.
"""

import os
import socket
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import graphs
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.ops.pipeline import make_forward_fn
from uit_mobile_tpu_torch import parallel
from uit_mobile_tpu_torch.parallel import collectives, multihost
from uit_mobile_tpu_torch.parallel import mesh as mesh_mod
from uit_mobile_tpu_torch.parallel.mesh import GridMesh, data_parallel_forward, make_mesh
from uit_mobile_tpu_torch.parallel.rows import Rows, ThreadGroup
from uit_mobile_tpu_torch.train import build_optimizer, make_framewise_train_step
from uit_mobile_tpu_torch.train import make_train_step
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train import steps as steps_mod
from uit_mobile_tpu_torch.train.loop import validation_forward

REPO = Path(__file__).resolve().parent.parent
SR, B = 16000, 4
torch.set_num_threads(1)


def _fake_backend(monkeypatch, backends):
    """dist.get_backend answers ``backends[group]`` (the default group: None)."""
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backends[group])


# ----------------------------------------------------------------- the rule

@pytest.mark.parametrize("backend, want", [("nccl", True), ("gloo", False), ("threads", False)])
def test_capturable_by_backend(monkeypatch, backend, want):
    group = ThreadGroup(2) if backend == "threads" else object()
    _fake_backend(monkeypatch, {group: backend} if backend != "threads" else {})
    assert collectives.capturable(group) is want


@pytest.mark.parametrize("device, backends, want", [
    ("cuda", ("nccl", "nccl"), True),
    ("cuda", ("nccl", "gloo"), False),
    ("cpu", ("nccl", "nccl"), False),
])
def test_grid_mesh_capturable_asks_every_axis(monkeypatch, device, backends, want):
    groups = {"data": object(), "model": object()}
    _fake_backend(monkeypatch, dict(zip(groups.values(), backends)))
    mesh = GridMesh({"data": 2, "model": 2}, {"data": 0, "model": 0}, groups,
                    torch.device(device, 0) if device == "cuda" else torch.device(device))
    assert mesh.capturable is want


GRAPHABLE = {  # name: (optimizer device, rows' backend (None: no rows), process group's
    #                    backend (None: none), the optimizer on an FSDP placement's shards,
    #                    graphable)
    "one_process": ("cuda", None, None, False, True),
    "cpu": ("cpu", None, None, False, False),
    "nccl_rows": ("cuda", "nccl", "nccl", False, True),
    "gloo_rows": ("cuda", "gloo", "gloo", False, False),
    "thread_rows": ("cuda", "threads", None, False, False),
    "nccl_no_rows": ("cuda", None, "nccl", False, True),  # a mesh whose data axis is 1
    "gloo_no_rows": ("cuda", None, "gloo", False, False),
    "nccl_fsdp": ("cuda", "nccl", "nccl", True, True),
    "gloo_fsdp": ("cuda", "gloo", "gloo", True, False),
}


@pytest.mark.parametrize("name", list(GRAPHABLE))
def test_graphable_under_rows(monkeypatch, name):
    device, rows_backend, pg_backend, fsdp, want = GRAPHABLE[name]
    # an FSDP placement's optimizer holds plain parameters: each rank's shards
    params = [torch.zeros(2, 3)[:, :1].contiguous() if fsdp else torch.zeros(2)]
    opt = types.SimpleNamespace(device=torch.device(device), params=params)
    rows = None
    if rows_backend == "threads":
        rows = types.SimpleNamespace(group=ThreadGroup(2))
    elif rows_backend is not None:
        rows = types.SimpleNamespace(group="data")
    _fake_backend(monkeypatch, {"data": rows_backend, None: pg_backend})
    monkeypatch.setattr(multihost, "is_initialized", lambda: pg_backend is not None)
    assert steps_mod._graphable(opt, rows) is want


@pytest.mark.parametrize("backend", [None, "nccl", "gloo"])
def test_validation_forward_replays_unless_gloo(monkeypatch, backend):
    fwd = types.SimpleNamespace(eager=object())
    rows = None if backend is None else types.SimpleNamespace(group=None)
    _fake_backend(monkeypatch, {None: backend})
    assert validation_forward(fwd, rows) is (fwd.eager if backend == "gloo" else fwd)


# ------------------------------------------------- the card's branch, forced

@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """This process as a process group of one gloo rank (a FileStore)."""
    store = dist.FileStore(str(tmp_path_factory.mktemp("pg") / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


class _HostReads(TorchDispatchMode):
    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.log["host_reads"] += 1
        return func(*args, **(kwargs or {}))


@pytest.fixture
def card_branch(monkeypatch):
    """``graphed`` recording what it is handed (the body then runs under a
    host-read counter); ``Rows`` builds counted by the call they fall in
    (0: before the first)."""
    log = {"handed": [], "calls": 0, "host_reads": 0, "rows_built_at_call": []}

    def fake_graphed(fn, device, agree=None):
        def run(*args):
            log["calls"] += 1
            with _HostReads(log):
                return fn(*args)

        log["handed"].append((fn, agree, run))
        return run

    init = Rows.__init__

    def counting_init(self, *args, **kwargs):
        log["rows_built_at_call"].append(log["calls"])
        init(self, *args, **kwargs)

    monkeypatch.setattr(graphs, "graphed", fake_graphed)
    monkeypatch.setattr(Rows, "__init__", counting_init)
    monkeypatch.setattr(GridMesh, "capturable", property(lambda self: True))
    monkeypatch.setattr(steps_mod, "_graphable", lambda opt, rows: True)
    return log


def _wav(seed, b=B, n=SR):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal((b, n)) * 0.1)
                            .astype(np.float32))


def _step_world(kind):
    """(cfg, fresh model, step factory(model, opt, rows) -> call(batch, gen), batch)."""
    if kind == "mae":
        enc = models.get_model_config("uit_xxxs", outputdim=21, target_length=160, depth=1)
        cfg = mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=1)

        def make(model, opt, rows):
            step = mae.make_mae_step(cfg, model, opt, rows=rows)
            return step, lambda b, g: step(b["wav"], g)

        return (cfg, lambda: mae.init(cfg, torch.Generator().manual_seed(1)), make,
                {"wav": _wav(1, n=160 * 160)})
    r = np.random.default_rng(2)
    if kind == "moe":
        cfg = models.get_model_config("uit_xs_moe", outputdim=13, target_length=102, depth=1)

        def make(model, opt, rows):
            step = parallel.make_moe_train_step(cfg, model, opt, rows=rows)
            return step, lambda b, g: step(b["wav"], b["target"], g)

        target = (r.uniform(size=(B, 13)) > 0.8).astype(np.float32)
    elif kind == "sed":
        cfg = models.get_model_config("uit_xxxs", outputdim=10, target_length=102, depth=1,
                                      pooling="dm")

        def make(model, opt, rows):
            step = make_framewise_train_step(cfg, model, opt, max_grad_norm=1.0, rows=rows)
            return step, step

        target = (r.uniform(size=(B, 6, 10)) > 0.7).astype(np.float32)
    else:
        cfg = models.get_model_config("uit_xxxs", outputdim=10, target_length=102, depth=1,
                                      drop_rate=0.1, drop_path_rate=0.1)

        def make(model, opt, rows):
            step = make_train_step(cfg, model, opt, mixup_alpha=0.5, max_grad_norm=1.0,
                                   rows=rows)
            return step, step

        target = (r.uniform(size=(B, 10)) > 0.7).astype(np.float32)
    return (cfg, lambda: models.build(cfg, torch.Generator().manual_seed(1), "cpu"), make,
            {"wav": _wav(3), "target": torch.from_numpy(target)})


@pytest.mark.parametrize("kind", ["weak", "sed", "mae", "moe"])
def test_rows_steps_take_the_replay_branch(one_rank, card_branch, kind):
    """A ``rows`` step over a one-rank group, the card's branch forced: its
    device side goes to ``graphed`` with the ranks' agreement, two calls
    read nothing on the host and build no Rows, and both are bitwise the
    single-process step's (eager, no rows)."""
    _, fresh, make, batch = _step_world(kind)
    runs = {}
    for how in ("single", "rows"):
        model = fresh()
        opt = build_optimizer("AdamW", 1e-3).init(model)
        rows = Rows([B], "cpu") if how == "rows" else None
        n_handed = len(card_branch["handed"])
        step, call = make(model, opt, rows)
        if how == "rows":
            body, agree, run = card_branch["handed"][n_handed]
            assert step.graphs is run and agree is not None and agree(True)
            card_branch["rows_built_at_call"].clear()
        gen = torch.Generator().manual_seed(4)
        out = [call(batch, gen) for _ in range(2)]
        losses = [m["total_loss"] if isinstance(m, dict) else m for m in out]
        runs[how] = losses + [p.detach().clone() for p in model.parameters()]
    assert card_branch["calls"] == 4 and card_branch["host_reads"] == 0
    assert card_branch["rows_built_at_call"] == []
    assert all(torch.equal(a, b) for a, b in zip(runs["rows"], runs["single"]))


def _record_data_shards(model, fitted, group):
    """An FSDP placement over a one-rank axis records no shard (an axis of
    one rank needs no collective): record its 'data' dims as a larger world
    does, so that the step gathers and reduce-scatters over the one rank."""
    shards = dict(getattr(model, "shards", {}))
    for name, spec in fitted.items():
        if "data" in spec:
            shards[name] = shards.get(name, ()) + ((spec.index("data"), "data", group),)
    model.shards, model.fsdp_axis = shards, "data"


@pytest.mark.parametrize("placement, kind", [("fsdp", "weak"), ("hybrid", "weak"),
                                             ("fsdp", "sed")])
def test_fsdp_steps_take_the_replay_branch(one_rank, card_branch, monkeypatch, placement,
                                           kind):
    """The FSDP and hybrid FSDP x TP steps (the weak step with mixup, and the
    SED step) on one rank, the card's branch forced: the device side goes to
    ``graphed`` with the ranks' agreement; each of two calls issues one
    all-gather and one reduce-scatter inside it, reads nothing on the host,
    builds no Rows, and equals the eager device side of the same step from
    the same start bitwise."""
    cfg, fresh, make, batch = _step_world(kind)
    counts = {"all_gather_into_tensor": 0, "reduce_scatter_tensor": 0}
    for name in counts:
        orig = getattr(dist, name)
        monkeypatch.setattr(dist, name, lambda *a, _n=name, _o=orig, **k: (
            counts.__setitem__(_n, counts[_n] + 1), _o(*a, **k))[1])
    runs = {}
    for how in ("eager", "graphed"):
        model = fresh()
        if placement == "fsdp":
            model, fitted = parallel.fsdp_shard_params(parallel.process_mesh("cpu"), model)
            group = None
        else:
            mesh = parallel.make_grid_mesh({"data": 1, "model": 1}, device="cpu")
            model, fitted = parallel.hybrid_shard_params(mesh, model)
            group = mesh.group("data")
        _record_data_shards(model, fitted, group)
        opt, _ = parallel.sharded_opt_init(build_optimizer("AdamW", 1e-3), model)
        rows = Rows([B], "cpu")
        n_handed = len(card_branch["handed"])
        step, _ = make(model, opt, rows)
        body, agree, run = card_branch["handed"][n_handed]
        assert step.graphs is run and agree is not None
        card_branch["rows_built_at_call"].clear()
        gen = torch.Generator().manual_seed(4)
        calls, host_reads = card_branch["calls"], card_branch["host_reads"]
        out = []
        for _ in range(2):
            if how == "eager":
                (kind,) = opt.plan(1)
                out.append(step.device_step(batch, gen, kind, opt.scalars(1)[0]))
            else:
                before = dict(counts)
                out.append(step(batch, gen))
                assert {k: counts[k] - before[k] for k in counts} == dict.fromkeys(counts, 1)
        assert card_branch["calls"] - calls == (2 if how == "graphed" else 0)
        assert card_branch["host_reads"] == host_reads == 0
        assert card_branch["rows_built_at_call"] == []
        runs[how] = ([m["total_loss"] for m in out] + [m["grad_norm"] for m in out]
                     + [p.detach().clone() for p in model.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(runs["graphed"], runs["eager"]))


def test_capture_agreement_on_one_rank(one_rank):
    agree = collectives.capture_agreement("cpu")
    assert agree(True) is True and agree(False) is False


def _mp_forward(route):
    """(fn factory(mesh), wav) of one model-parallel route at one rank."""
    if route == "ep":
        cfg = models.get_model_config("uit_xs_moe", outputdim=13, target_length=102, depth=2,
                                      n_experts=4)
        model = models.build(cfg, torch.Generator().manual_seed(5), "cpu")
        return (lambda mesh: parallel.expert_parallel_forward(cfg, model, mesh),
                {"data": 1, "expert": 1})
    cfg = models.get_model_config("uit_xxxs", outputdim=11, target_length=102, depth=2)
    model = models.build(cfg, torch.Generator().manual_seed(5), "cpu")
    fe = make_frontend_fn(cfg.frontend)
    if route == "tp":
        return (lambda mesh: parallel.tensor_parallel_forward(
            lambda m, w: models.apply(cfg, m, w, frontend_fn=fe), mesh, model,
            shard_attention=True), {"data": 1, "model": 1})
    if route == "sp":
        return (lambda mesh: parallel.sequence_parallel_forward(
            cfg, model, mesh, data_axis="data", frontend_fn=fe), {"data": 1, "seq": 1})
    return (lambda mesh: parallel.pipeline_forward(cfg, model, mesh, data_axis="data",
                                                   n_microbatches=2, frontend_fn=fe),
            {"data": 1, "pipe": 1})


@pytest.mark.parametrize("route", ["tp", "sp", "pp", "ep"])
def test_mp_forwards_take_the_replay_branch(one_rank, card_branch, route):
    """Each model-parallel forward at one rank, the card's branch forced:
    its body goes to ``graphed`` with the ranks' agreement (``fn.graphs``),
    reads nothing on the host, and its calls equal ``fn.eager`` bitwise."""
    factory, shape = _mp_forward(route)
    fn = factory(parallel.make_grid_mesh(shape, device="cpu"))
    body, agree, run = card_branch["handed"][-1]
    assert fn.graphs is run and agree is not None
    wav = _wav(6)
    eager = fn.eager(wav)
    got = [fn(wav) for _ in range(2)]
    assert card_branch["calls"] == 2 and card_branch["host_reads"] == 0
    assert all(torch.equal(g, eager) for g in got)


def test_mp_forwards_stay_eager_off_the_card(one_rank):
    factory, shape = _mp_forward("pp")
    fn = factory(parallel.make_grid_mesh(shape, device="cpu"))
    assert fn.graphs is None and fn.eager is fn


def test_shard_rows_builds_each_share_once(one_rank, monkeypatch):
    """``GridMesh.shard_rows`` keeps one ``Rows`` a (axis, local rows): a
    forward's body copies no row ids from the host after its first call."""
    built = []
    init = Rows.__init__
    monkeypatch.setattr(Rows, "__init__", lambda self, *a, **k: (built.append(a),
                                                                 init(self, *a, **k))[1])
    mesh = GridMesh({"data": 2}, {"data": 1}, {"data": None}, torch.device("cpu"))
    wav = _wav(7, b=8)
    (a, ra), (b, rb) = mesh.shard_rows(wav, "data"), mesh.shard_rows(wav + 1, "data")
    assert ra is rb and len(built) == 1 and torch.equal(a, wav[4:])
    _, rc = mesh.shard_rows(wav[:4], "data")
    assert rc is not ra and len(built) == 2


def test_capture_agreement_fails_on_every_rank(tmp_path):
    """Two gloo ranks: rank 0's capture failed, rank 1's did not -> both are
    told it failed; then both succeed -> both are told so."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = textwrap.dedent(f"""
        import sys
        from uit_mobile_tpu_torch.parallel import collectives, multihost
        rank = int(sys.argv[1])
        multihost.initialize("127.0.0.1:{port}", 2, rank, strict=True, device="cpu",
                             timeout=60)
        agree = collectives.capture_agreement("cpu")
        print("AGREED", agree(rank != 0), agree(True), flush=True)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", src, str(r)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, PYTHONPATH=str(REPO)))
             for r in range(2)]
    try:
        outs = [p.communicate(timeout=120)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        assert "AGREED False True" in out, out


# ------------------------------------------------- in-process replicas

def _dp_model(moe=False):
    name = "uit_xs_moe" if moe else "uit_xxxs"
    kw = dict(n_experts=4) if moe else {}
    cfg = models.get_model_config(name, outputdim=11, target_length=102, depth=1, **kw)
    return cfg, models.build(cfg, torch.Generator().manual_seed(8), "cpu")


def _threaded(fns, mesh):
    """The threaded eager route over the same replicas (forwards that say
    nothing of their rows)."""
    return data_parallel_forward([lambda w, f=f: f.eager(w) for f in fns], mesh)


def test_dp_per_sample_runs_each_replica_without_threads(card_branch, monkeypatch):
    """Per-sample forwards over two replicas: each replica's own forward
    (its ``graphed`` body, the card's branch forced) runs once a call from
    the calling thread, no ThreadGroup is made, and the output is bitwise
    the threaded route's."""
    cfg, model = _dp_model()
    mesh = make_mesh(devices=["cpu", "cpu"])
    fns = [make_forward_fn(cfg, model, use_kernel=True, precision="fast",
                           top_db_mode="per_sample") for _ in range(2)]
    assert not any(f.batch_global for f in fns)
    wav = _wav(9, b=8)
    want = _threaded(fns, mesh)(wav)
    dp = data_parallel_forward(fns, mesh)
    assert dp.threaded is False and dp.replicas == fns
    monkeypatch.setattr(mesh_mod, "ThreadGroup", None)  # a ThreadGroup would raise
    calls = card_branch["calls"]
    got = dp(wav)
    assert card_branch["calls"] == calls + 2 and card_branch["host_reads"] == 0
    assert torch.equal(got, want)
    assert [f.graphs for f in fns] == [h[2] for h in card_branch["handed"]]


@pytest.mark.parametrize("case", ["torch_clamp", "moe", "says_nothing"])
def test_dp_keeps_threads_where_rows_meet(case):
    """The batch-global clamp, the MoE's routing groups and a forward that
    says nothing of its rows run the threaded route."""
    cfg, model = _dp_model(moe=case == "moe")
    mesh = make_mesh(devices=["cpu", "cpu"])
    if case == "says_nothing":
        fwd = lambda w: models.apply(cfg, model, w)  # noqa: E731
    else:
        fwd = make_forward_fn(cfg, model, use_kernel=True,
                              top_db_mode="torch" if case == "torch_clamp" else "per_sample")
        assert fwd.batch_global
    dp = data_parallel_forward(fwd, mesh)
    assert dp.threaded is True
    wav = _wav(10, b=8)
    torch.testing.assert_close(dp(wav), fwd(wav), atol=2e-5, rtol=0)


@pytest.mark.parametrize("mode, want", [("per_sample", graphs.WARMUP + 1), ("torch", 1)])
def test_warmed_dp_service_holds_every_bucket_graph(card_branch, mode, want):
    """``calls_to_capture`` of a data-parallel forward is its replicas'
    (each replays its own graph): a warmed service over two replicas calls
    every replica's graphed forward until each bucket's graph is held,
    before its worker starts; the threaded clamp route warms once, eagerly."""
    from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

    cfg, model = _dp_model()
    mesh = make_mesh(devices=["cpu", "cpu"])
    conf = ServiceConfig(batch_size=8, max_seconds=2, top_db_mode=mode, data_parallel=mesh)
    svc = TaggingService(cfg, model, conf, device="cpu", _start_worker=False)
    assert svc._fwd.threaded is (mode == "torch")
    assert graphs.calls_to_capture(svc._fwd) == want
    graphed_calls = 0 if mode == "torch" else want * len(svc._buckets) * mesh.size
    assert card_branch["calls"] == graphed_calls and card_branch["host_reads"] == 0
