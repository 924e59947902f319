"""The placed eval forward (``parallel.fsdp_forward``) on the card: this
process as one NCCL rank over a FileStore, uit_xxs placed by
``fsdp_shard_params`` or ``hybrid_shard_params`` on a mesh of ones (a
placement that splits nothing: one rank holds the whole model). The
forward is a CUDA graph per batch shape; each call after the capture is
one replay that launches ``row_exact`` once, bitwise its eager call and
within 2e-5 in probabilities of ``models.apply`` on the same model.

Every test here is marked ``gpu`` and skips without a CUDA GPU. The file
imports neither jax nor the JAX package:

    python -m pytest --noconftest -m gpu tests/test_torch_placed_gpu.py -q -s
"""

import numpy as np
import pytest
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ops import launches
from uit_mobile_tpu_torch.ops.graphs import calls_to_capture


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
@pytest.mark.parametrize("placement", ["fsdp", "hybrid"])
def test_nccl_placed_forward_replay_bitwise_eager(nccl_rank, placement):
    from uit_mobile_tpu_torch import parallel
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn

    cuda = nccl_rank
    cfg = models.get_model_config("uit_xxs", outputdim=537, target_length=102)
    model = models.build(cfg, torch.Generator().manual_seed(7), device=cuda)
    if placement == "fsdp":
        mesh = parallel.process_mesh(cuda)
        model, _ = parallel.fsdp_shard_params(mesh, model)
    else:
        mesh = parallel.make_grid_mesh({"data": 1, "model": 1}, device=cuda)
        model, _ = parallel.hybrid_shard_params(mesh, model)
    assert model.fsdp_axis == "data" and not model.shards
    fe = make_frontend_fn(cfg.frontend)
    fn = parallel.fsdp_forward(lambda m, w: models.apply(cfg, m, w, frontend_fn=fe), mesh, model)
    assert fn.graphs is not None
    x = torch.from_numpy((np.random.default_rng(8).standard_normal((16, 16000)) * 0.1)
                         .astype(np.float32)).to(cuda)
    eager = fn.eager(x)
    for _ in range(calls_to_capture(fn)):
        fn(x)
    n = sum(s["replays"] for s in fn.graphs.stats())
    for k in launches:
        launches[k] = 0
    got = fn(x)
    torch.cuda.synchronize()
    assert sum(s["replays"] for s in fn.graphs.stats()) == n + 1
    assert launches["row_exact"] == 1 and sum(launches.values()) == 1
    assert torch.equal(got, eager)
    want = models.apply(cfg, model, x, frontend_fn=fe)
    assert float((got - want).abs().max()) <= 2e-5
    print(f"{placement}: {fn.graphs.stats()}")
