"""The port's CUDA graphs on the card (ops/graphs.py): a serving forward
per bucket (B=256 x 1 s int16 ``tfb_fast``, B=85 x 3 s ``row_fast``), a
K=3 scanned forward and one train step (PSL teacher, mixup, clipping),
each replay bitwise its eager call on the same inputs, and each call one
replay that runs the mel kernel.

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
