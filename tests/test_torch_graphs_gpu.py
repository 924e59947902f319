"""The port's CUDA graphs on the card (ops/graphs.py): a serving forward
per bucket (B=256 x 1 s int16 ``tfb_fast``, B=85 x 3 s ``row_fast``), a
K=3 scanned forward and one train step (PSL teacher, mixup, clipping),
each replay bitwise its eager call on the same inputs, and each call one
replay that runs the mel kernel. Then the routes of a process group, this
process as one NCCL rank over a FileStore: a train step under ``rows``
(its all-reduces in the graph) and the TP, SP, PP and EP forwards, each
replay bitwise its eager call; and the per-sample data-parallel forward
over two replicas of the card, one replay a replica, bitwise the threaded
eager route.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_graphs_gpu.py -q -s
"""

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import launches, make_forward_fn, make_scanned_forward
from uit_mobile_tpu_torch.ops.graphs import calls_to_capture

torch.set_num_threads(4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs and the mel kernel have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    cfg = models.get_model_config("uit_xxs", outputdim=537, target_length=102)
    return cfg, models.build(cfg, torch.Generator().manual_seed(3), device="cpu")


def _pcm(seed, *shape):
    return (np.random.default_rng(seed).standard_normal(shape) * 3000).astype(np.int16)


def _replays(g) -> int:
    return sum(s["replays"] for s in g.stats())


@pytest.mark.gpu
@pytest.mark.parametrize("B, seconds, variant", [(256, 1, "tfb_fast"), (85, 3, "row_fast")])
def test_forward_replay_bitwise_eager(cuda, model, B, seconds, variant):
    cfg, m = model
    fwd = make_forward_fn(cfg, m.to(cuda), precision="fast", top_db_mode="per_sample")
    x = torch.from_numpy(_pcm(B, B, seconds * 16000)).to(cuda)
    with torch.inference_mode():
        eager = fwd.graphs.fn(x)
    for _ in range(calls_to_capture(fwd)):
        fwd(x)
    n = _replays(fwd.graphs)
    for k in launches:
        launches[k] = 0
    got = fwd(x)
    torch.cuda.synchronize()
    assert _replays(fwd.graphs) == n + 1
    assert launches[variant] == 1 and sum(launches.values()) == 1
    assert torch.equal(got, eager)
    print(f"B={B} x {seconds} s: {fwd.graphs.stats()}")


@pytest.mark.gpu
def test_scanned_forward_is_one_replay(cuda, model):
    cfg, m = model
    fwd = make_forward_fn(cfg, m.to(cuda), precision="fast", top_db_mode="per_sample")
    scanned = make_scanned_forward(fwd)
    block = torch.from_numpy(_pcm(7, 3, 256, 16000)).to(cuda)
    with torch.inference_mode():
        eager = torch.stack([fwd.graphs.fn(block[k]) for k in range(3)])
    for _ in range(calls_to_capture(scanned)):
        scanned(block)
    n = _replays(scanned.graphs)
    for k in launches:
        launches[k] = 0
    got = scanned(block)
    torch.cuda.synchronize()
    assert _replays(scanned.graphs) == n + 1 and launches["tfb_fast"] == 3
    assert torch.equal(got, eager)


@pytest.mark.gpu
def test_train_step_replay_bitwise_eager(cuda):
    """Two runs of 4 steps from one state and generator state, one eager
    and one graphed (an eager warm-up, then 3 replays): parameters, BN
    buffers, moments, the EMA and the generator's offset equal bitwise,
    where two eager runs agree bitwise."""
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.train import (build_optimizer, cosine_with_warmup,
                                            make_train_step, wrap_optimizer)

    cfg = models.get_model_config("uit_xxs", outputdim=537, target_length=102)
    t_cfg = models.get_model_config("MobileNetV2", outputdim=527)
    student = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(1), "cpu"))
    teacher = module_to_numpy(models.build(t_cfg, torch.Generator().manual_seed(2), "cpu"))
    r = np.random.default_rng(4)
    batches = [{"wav": torch.from_numpy((r.standard_normal((32, 16000)) * 0.1)
                                        .astype(np.float32)).to(cuda),
                "target": torch.from_numpy((r.uniform(size=(32, 537)) > 0.9)
                                           .astype(np.float32)).to(cuda)} for _ in range(4)]

    def run(graphed: bool):
        model = module_from_numpy(cfg, *student, device=cuda)
        t_model = module_from_numpy(t_cfg, *teacher, device=cuda).requires_grad_(False)
        opt = wrap_optimizer(build_optimizer("AdamW", cosine_with_warmup(1e-3, 10, 2)),
                             ema_decay=0.99).init(model)
        step = make_train_step(cfg, model, opt, psl_cfg=t_cfg, psl_model=t_model,
                               psl_split=16, mixup_alpha=0.3, max_grad_norm=1.0,
                               frontend_fn=make_frontend_fn(cfg.frontend),
                               psl_frontend_fn=make_frontend_fn(t_cfg.frontend,
                                                                layout="tfb_to_bft"))
        gen = torch.Generator(device=cuda).manual_seed(5)
        for b in batches:
            if graphed:
                step(b, gen)
            else:
                (kind,) = opt.plan(1)
                step.device_step(b, gen, kind, opt.scalars(1)[0])
        torch.cuda.synchronize()
        if graphed:
            assert _replays(step.graphs) == len(batches) - 1
        return ([v.clone() for v in model.state_dict().values()]
                + [t.clone() for t in opt.state_leaves()[1:]], gen.get_offset())

    (e1, o1), (e2, o2), (g, og) = run(False), run(False), run(True)
    if all(torch.equal(a, b) for a, b in zip(e1, e2)) and o1 == o2:
        assert og == o1
        assert all(torch.equal(a, b) for a, b in zip(g, e1))
    else:
        spread = max(float((a - b).abs().max()) for a, b in zip(e1, e2))
        gap = max(float((a - b).abs().max()) for a, b in zip(g, e1))
        print(f"eager runs differ by {spread}; graphed vs eager {gap}")
        assert gap <= 2 * spread


@pytest.fixture(scope="module")
def nccl_rank(tmp_path_factory):
    """This process as a process group of one NCCL rank (a FileStore)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: NCCL and CUDA graphs have no CPU mode")
    import torch.distributed as dist

    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    yield torch.device("cuda", 0)
    dist.destroy_process_group()


@pytest.mark.gpu
def test_nccl_rows_step_replay_bitwise_eager(nccl_rank):
    """The weak step (mixup, clipping) under ``rows`` of one NCCL rank: two
    eager runs and one graphed run (an eager warm-up, then 3 replays holding
    the step's all-reduces) of 4 steps from one state: parameters, BN
    buffers, moments and the generator's offset bitwise, where the two
    eager runs agree bitwise."""
    from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.parallel.rows import Rows
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    cuda = nccl_rank
    cfg = models.get_model_config("uit_xxs", outputdim=537, target_length=102)
    start = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(1), "cpu"))
    r = np.random.default_rng(6)
    batches = [{"wav": torch.from_numpy((r.standard_normal((32, 16000)) * 0.1)
                                        .astype(np.float32)).to(cuda),
                "target": torch.from_numpy((r.uniform(size=(32, 537)) > 0.9)
                                           .astype(np.float32)).to(cuda)} for _ in range(4)]
    rows = Rows([32], cuda)

    def run(graphed: bool):
        model = module_from_numpy(cfg, *start, device=cuda)
        opt = build_optimizer("AdamW", 1e-3).init(model)
        step = make_train_step(cfg, model, opt, mixup_alpha=0.3, max_grad_norm=1.0,
                               frontend_fn=make_frontend_fn(cfg.frontend), rows=rows)
        assert step.graphs is not None
        gen = torch.Generator(device=cuda).manual_seed(5)
        for b in batches:
            if graphed:
                step(b, gen)
            else:
                (kind,) = opt.plan(1)
                step.device_step(b, gen, kind, opt.scalars(1)[0])
        torch.cuda.synchronize()
        if graphed:
            assert _replays(step.graphs) == len(batches) - 1
        return ([v.clone() for v in model.state_dict().values()]
                + [t.clone() for t in opt.state_leaves()[1:]], gen.get_offset())

    (e1, o1), (e2, o2), (g, og) = run(False), run(False), run(True)
    if all(torch.equal(a, b) for a, b in zip(e1, e2)) and o1 == o2:
        assert og == o1
        assert all(torch.equal(a, b) for a, b in zip(g, e1))
    else:
        spread = max(float((a - b).abs().max()) for a, b in zip(e1, e2))
        gap = max(float((a - b).abs().max()) for a, b in zip(g, e1))
        print(f"eager runs differ by {spread}; graphed vs eager {gap}")
        assert gap <= 2 * spread


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["tp", "sp", "pp", "ep"])
def test_nccl_mp_forward_replay_bitwise_eager(nccl_rank, route):
    """Each model-parallel forward on a mesh of ones over the NCCL rank: a
    graph per batch shape, each call after the capture one replay that
    launches ``row_exact`` once, bitwise its eager call."""
    from uit_mobile_tpu_torch import parallel
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn

    cuda = nccl_rank
    moe = route == "ep"
    cfg = (models.get_model_config("uit_xs_moe", outputdim=537, target_length=102, depth=2,
                                   n_experts=4) if moe
           else models.get_model_config("uit_xxs", outputdim=537, target_length=102))
    model = models.build(cfg, torch.Generator().manual_seed(7), device=cuda)
    fe = make_frontend_fn(cfg.frontend)
    axis = {"tp": "model", "sp": "seq", "pp": "pipe", "ep": "expert"}[route]
    mesh = parallel.make_grid_mesh({"data": 1, axis: 1}, device=cuda)
    if route == "tp":
        fn = parallel.tensor_parallel_forward(
            lambda m, w: models.apply(cfg, m, w, frontend_fn=fe), mesh, model)
    elif route == "sp":
        fn = parallel.sequence_parallel_forward(cfg, model, mesh, data_axis="data",
                                                frontend_fn=fe)
    elif route == "pp":
        fn = parallel.pipeline_forward(cfg, model, mesh, data_axis="data", n_microbatches=4,
                                       frontend_fn=fe)
    else:
        fn = parallel.expert_parallel_forward(cfg, model, mesh, frontend_fn=fe)
    assert fn.graphs is not None
    x = torch.from_numpy(_pcm(8, 16, 16000).astype(np.float32) / 32768.0).to(cuda)
    eager = fn.eager(x)
    for _ in range(calls_to_capture(fn)):
        fn(x)
    n = _replays(fn.graphs)
    for k in launches:
        launches[k] = 0
    got = fn(x)
    torch.cuda.synchronize()
    assert _replays(fn.graphs) == n + 1
    assert launches["row_exact"] == 1 and sum(launches.values()) == 1
    assert torch.equal(got, eager)
    print(f"{route}: {fn.graphs.stats()}")


@pytest.mark.gpu
def test_dp_per_sample_replays_each_replica(cuda, model):
    """The per-sample serving forward over two replicas of the card: each
    replica replays its own graph (no thread), bitwise the threaded eager
    route on the same batch."""
    from uit_mobile_tpu_torch.parallel import data_parallel_forward, make_mesh, replicate_tree

    cfg, m = model
    mesh = make_mesh(devices=[cuda, cuda])
    fns = [make_forward_fn(cfg, r, precision="fast", top_db_mode="per_sample")
           for r in replicate_tree(mesh, m.to(cuda))]
    dp = data_parallel_forward(fns, mesh)
    threaded = data_parallel_forward([lambda w, f=f: f.eager(w) for f in fns], mesh)
    assert not dp.threaded and threaded.threaded
    x = torch.from_numpy(_pcm(9, 64, 16000)).to(cuda)
    want = threaded(x)
    for _ in range(calls_to_capture(fns[0])):
        dp(x)
    n = [_replays(f.graphs) for f in fns]
    got = dp(x)
    torch.cuda.synchronize()
    assert [_replays(f.graphs) for f in fns] == [k + 1 for k in n]
    assert torch.equal(got, want)
