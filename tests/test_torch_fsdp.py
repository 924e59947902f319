"""FSDP of the port (uit_mobile_tpu_torch.parallel.fsdp) on the CPU.

The placement rule equals ``uit_mobile_tpu.parallel.fsdp_param_specs`` on
the same tree (uit_xxxs, depth 2, outputdim 37, and MobileNetV2); 2 gloo
ranks in child processes shard the model with FSDP2 ``fully_shard`` and
take one weak train step (mixup, wave and spectrogram augments, dropout,
AdamW, clipping) on their rows of the global batch; the result must be the
single-process step on the whole batch, at the gates of
tests/test_torch_parallel.py (loss 1e-5 relative, pre-clip norm 1e-4
relative, gradients 1e-5 of each tensor's largest, parameters 5e-5 plus
what the gradient gate can move Adam's first step). Each rank's shards,
and the first moments of the port's AdamW, hold 1/2 of every sharded
tensor.
"""

import importlib.util
import json
import sys

import jax
import numpy as np
import pytest

from test_torch_parallel import _free_port, _param_bound, spawn_ranks
from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.parallel import fsdp_param_specs as jax_fsdp_param_specs
from uit_mobile_tpu.parallel import hybrid_param_specs as jax_hybrid_param_specs
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.parallel.fsdp import _fit, fsdp_param_specs, hybrid_param_specs

STEP_SRC = r'''
import json
import sys

import numpy as np
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

torch.set_num_threads(1)
CFG = dict(outputdim=37, target_length=102, depth=2, drop_rate=0.1, drop_path_rate=0.2,
           act="gelu")
KW = dict(mixup_alpha=0.5, max_grad_norm=1.0,
          wav_augment=parse_wavtransforms({"Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}}),
          spec_augment=parse_spectransforms({"TimeMasking": {"time_mask_param": 20}}))


def batch(B=8):
    r = np.random.default_rng(5)
    return {"wav": torch.from_numpy((r.standard_normal((B, 16000)) * 0.1).astype(np.float32)),
            "target": torch.from_numpy((r.uniform(size=(B, 37)) > 0.7).astype(np.float32))}


def model():
    cfg = models.get_model_config("uit_xxxs", **CFG)
    return cfg, models.build(cfg, torch.Generator().manual_seed(0), device="cpu")


def single():
    cfg, m = model()
    opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(m)
    out = make_train_step(cfg, m, opt, **KW)(batch(), torch.Generator().manual_seed(3))
    return out, {n: p.detach().numpy().copy() for n, p in m.named_parameters()}, \
        {n: (mu / 0.1).numpy() for n, mu in zip(opt.names, opt.moments[0])}


if __name__ == "__main__":
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from uit_mobile_tpu_torch.parallel import multihost, process_mesh
    from uit_mobile_tpu_torch.parallel.fsdp import fsdp_shard_params, make_fsdp_train_step
    from uit_mobile_tpu_torch.parallel.rows import Rows

    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device="cpu",
                         timeout=120)
    cfg, m = model()
    root, specs = fsdp_shard_params(process_mesh("cpu"), m)
    opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(root.model)
    b = batch()
    sl = multihost.host_local_batch_slice(len(b["wav"]))
    step = make_fsdp_train_step(cfg, root, opt, rows=Rows([sl.stop - sl.start], "cpu"), **KW)
    out = step({k: v[sl] for k, v in b.items()}, torch.Generator().manual_seed(3))
    res = {"loss": out["total_loss"].item(), "grad_norm": out["grad_norm"].item()}
    full = lambda t: (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()  # noqa
    local = {}
    for n, p in root.model.named_parameters():
        local[n] = list((p.to_local() if hasattr(p, "to_local") else p).shape)
        np.save(f"{workdir}/r{rank}.p.{n}.npy", full(p).numpy())
    moments = {}
    for n, mu in zip(opt.names, opt.moments[0]):
        moments[n] = list((mu.to_local() if hasattr(mu, "to_local") else mu).shape)
        np.save(f"{workdir}/r{rank}.g.{n}.npy", (full(mu) / 0.1).numpy())
    json.dump({"metrics": res, "local": local, "moments": moments,
               "specs": {k: list(v) for k, v in specs.items()}},
              open(f"{workdir}/r{rank}.json", "w"))
    print(f"DONE {rank}", flush=True)
'''


def _load(path):
    spec = importlib.util.spec_from_file_location("fsdp_step", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name, kw", [
    ("uit_xxxs", dict(outputdim=37, target_length=102, depth=2)),
    ("MobileNetV2", dict(outputdim=17)),
])
@pytest.mark.parametrize("min_size", [1024, 100])
def test_placements_equal_jax(name, kw, min_size):
    import torch

    from uit_mobile_tpu_torch import models

    jcfg = jax_models.get_model_config(name, **kw)
    params, _ = jax_models.build(jcfg, jax.random.key(0))
    want = flatten_tree(jax_fsdp_param_specs(params, min_size=min_size), ".",)
    flat = flatten_tree(jax.tree.map(np.asarray, params), ".")
    got = fsdp_param_specs(flat, min_size=min_size)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)
    assert any(got.values()) and any(not v for v in got.values())
    if name == "uit_xxxs":  # the module form names the same tensors, in JAX's layout
        cfg = models.get_model_config(name, **kw)
        module = models.build(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert fsdp_param_specs(module, min_size=min_size) == got
    # a dim the axis does not divide stays replicated, as JAX's _fit_spec
    assert _fit(("data", None), (37, 8), 2) == (None, None)
    assert _fit((None, "data"), (37, 8), 2) == (None, "data")
    # the FSDP x TP composition: JAX's hybrid specs (tests/test_torch_model_parallel.py
    # holds them at both shard_attention settings and runs the hybrid step)
    want = flatten_tree(jax_hybrid_param_specs(params, min_size=min_size), ".")
    got = hybrid_param_specs(flat, min_size=min_size)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)


def test_fsdp_step_equals_the_single_process_step(tmp_path):
    path = tmp_path / "fsdp_step.py"
    path.write_text(STEP_SRC)
    mod = _load(path)
    want, want_p, want_g = mod.single()
    port = _free_port()
    spawn_ranks(lambda r: [sys.executable, str(path), str(r), "2", str(port), str(tmp_path)], 2)
    infos = [json.loads((tmp_path / f"r{r}.json").read_text()) for r in range(2)]
    got = infos[0]["metrics"]
    assert got == infos[1]["metrics"]
    assert got["loss"] == pytest.approx(want["total_loss"].item(), rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want["grad_norm"].item(), rel=1e-4)
    specs = infos[0]["specs"]
    for n, v in want_p.items():
        full = [np.load(tmp_path / f"r{r}.p.{n}.npy") for r in range(2)]
        assert np.array_equal(full[0], full[1]), n
        g, wg = np.load(tmp_path / f"r0.g.{n}.npy"), want_g[n]
        assert np.abs(g - wg).max() <= 1e-5 * max(np.abs(wg).max(), 1e-30), n
        assert (np.abs(full[0] - v) <= _param_bound(wg)).all(), n
        # the shards and the moments are 1/2 of every sharded tensor
        shape, local, mom = list(v.shape), infos[0]["local"][n], infos[0]["moments"][n]
        if "data" in specs[n]:
            d = specs[n].index("data")
            assert local[d] * 2 == shape[d] and mom == local, n
        else:
            assert local == shape, n
    assert any("data" in s for s in specs.values())
