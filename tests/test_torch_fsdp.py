"""FSDP of the port (uit_mobile_tpu_torch.parallel.fsdp) on the CPU.

The placement rule equals ``uit_mobile_tpu.parallel.fsdp_param_specs`` on
the same tree (uit_xxxs, depth 2, outputdim 37, and MobileNetV2); 2 gloo
ranks in child processes place the model with ``fsdp_shard_params`` and
take three weak train steps (``make_train_step`` on the placed model:
mixup, wave and spectrogram augments, dropout, AdamW, clipping) on their
rows of three global batches; after the first and after the third the
result must be the single-process steps on the whole batches, at the
gates of tests/test_torch_parallel.py (loss 1e-5 relative, pre-clip norm
1e-4 relative, each step's gradients 1e-5 of each tensor's largest,
parameters 5e-5 plus what the gradient gate can move each Adam step,
summed over the steps taken). A stale gather (weights one update old)
shows from the second step on. Between the steps each rank's parameters
and the moments of the port's AdamW hold 1/2 of every sharded tensor, and
each step issues exactly one all-gather and one reduce-scatter over the
data group on top of the collectives of the unplaced step under the same
rows, and no module or parameter hook.
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
from uit_mobile_tpu_torch.parallel.fsdp import fsdp_param_specs, hybrid_param_specs
from uit_mobile_tpu_torch.parallel.mesh import GridMesh
from uit_mobile_tpu_torch.parallel.tp import _fit_spec

STEPS = 3
STEP_SRC = r"""
import collections
import json
import sys

import numpy as np
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

torch.set_num_threads(1)
STEPS = 3
CFG = dict(outputdim=37, target_length=102, depth=2, drop_rate=0.1, drop_path_rate=0.2,
           act="gelu")
KW = dict(mixup_alpha=0.5, max_grad_norm=1.0,
          wav_augment=parse_wavtransforms({"Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}}),
          spec_augment=parse_spectransforms({"TimeMasking": {"time_mask_param": 20}}))


def batch(i, B=8):
    r = np.random.default_rng(5 + i)
    return {"wav": torch.from_numpy((r.standard_normal((B, 16000)) * 0.1).astype(np.float32)),
            "target": torch.from_numpy((r.uniform(size=(B, 37)) > 0.7).astype(np.float32))}


def model():
    cfg = models.get_model_config("uit_xxxs", **CFG)
    return cfg, models.build(cfg, torch.Generator().manual_seed(0), device="cpu")


def recording(opt):
    # each micro-step's gradients (after clipping) as the update takes them
    grads, update = [], opt.device_update

    def recorded(g, kind, row):
        grads.append([v.detach().clone() for v in g])
        return update(g, kind, row)

    opt.device_update = recorded
    return grads


def single():
    # -> per step: metrics, params, gradients
    cfg, m = model()
    opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(m)
    grads = recording(opt)
    step, gen, out = make_train_step(cfg, m, opt, **KW), torch.Generator().manual_seed(3), []
    for i in range(STEPS):
        res = step(batch(i), gen)
        out.append(({"loss": res["total_loss"].item(), "grad_norm": res["grad_norm"].item()},
                    {n: p.detach().numpy().copy() for n, p in m.named_parameters()},
                    {n: g.numpy() for n, g in zip(opt.names, grads[i])}))
    return out


if __name__ == "__main__":
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    import torch.distributed as dist

    from uit_mobile_tpu_torch.parallel import multihost, process_mesh, sharded_opt_init
    from uit_mobile_tpu_torch.parallel.fsdp import fsdp_shard_params
    from uit_mobile_tpu_torch.parallel.rows import Rows
    from uit_mobile_tpu_torch.parallel.tp import gather_params

    counts = collections.Counter()
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
                 "broadcast"):
        def wrapped(*a, _orig=getattr(dist, name), _name=name, **k):
            group = k.get("group")
            counts[_name + (":world" if group is None else ":group")] += 1
            return _orig(*a, **k)

        setattr(dist, name, wrapped)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device="cpu",
                         timeout=120)
    sl = multihost.host_local_batch_slice(8)
    rows = Rows([sl.stop - sl.start], "cpu")
    # the unplaced step under the same rows: the collectives FSDP adds to
    cfg, m = model()
    step = make_train_step(cfg, m, build_optimizer("AdamW", 1e-3).init(m), rows=rows, **KW)
    step({k: v[sl] for k, v in batch(0).items()}, torch.Generator().manual_seed(3))
    plain = dict(counts)

    cfg, m = model()
    m, specs = fsdp_shard_params(process_mesh("cpu"), m)
    opt, _ = sharded_opt_init(build_optimizer("AdamW", 1e-3, weight_decay=1e-8), m)
    grads = recording(opt)
    step, gen = make_train_step(cfg, m, opt, rows=rows, **KW), torch.Generator().manual_seed(3)
    info = {"specs": {k: list(v) for k, v in specs.items()}, "plain_counts": plain,
            "counts": [], "metrics": [], "local": [], "moments": []}
    for i in range(STEPS):
        counts.clear()
        out = step({k: v[sl] for k, v in batch(i).items()}, gen)
        info["counts"].append(dict(counts))
        info["metrics"].append({"loss": out["total_loss"].item(),
                                "grad_norm": out["grad_norm"].item()})
        info["local"].append({n: list(p.shape) for n, p in m.named_parameters()})
        info["moments"].append({n: [list(mu.shape), list(nu.shape)] for n, mu, nu in
                                zip(opt.names, *opt.moments)})
        whole = {"p": gather_params(m), "g": gather_params(m, dict(zip(opt.names, grads[i])))}
        for kind, tensors in whole.items():
            for n, t in tensors.items():
                np.save(f"{workdir}/r{rank}.s{i}.{kind}.{n}.npy", t.numpy())
    info["hooks"] = sum(len(h) for mod in m.modules() for h in (
        mod._forward_hooks, mod._forward_pre_hooks, mod._backward_hooks,
        mod._backward_pre_hooks)) + sum(len(getattr(p, "_post_accumulate_grad_hooks", None)
                                            or {}) for p in m.parameters())
    info["fsdp_modules"] = sorted(k for k in sys.modules if k.startswith(
        ("torch.distributed.fsdp", "torch.distributed.tensor")))
    json.dump(info, open(f"{workdir}/r{rank}.json", "w"))
    print(f"DONE {rank}", flush=True)
"""


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
    # (fsdp_shard_params places through tp.place_params on a one-axis grid)
    grid = GridMesh({"data": 2}, {"data": 0}, {}, "cpu")
    assert _fit_spec(("data", None), (37, 8), grid) == (None, None)
    assert _fit_spec((None, "data"), (37, 8), grid) == (None, "data")
    # the FSDP x TP composition: JAX's hybrid specs (tests/test_torch_model_parallel.py
    # holds them at both shard_attention settings and runs the hybrid step)
    want = flatten_tree(jax_hybrid_param_specs(params, min_size=min_size), ".")
    got = hybrid_param_specs(flat, min_size=min_size)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)


@pytest.fixture(scope="module")
def fsdp_run(tmp_path_factory):
    """The 2 ranks' three FSDP steps and the single process's -> (ranks' infos,
    single steps, workdir)."""
    workdir = tmp_path_factory.mktemp("fsdp")
    path = workdir / "fsdp_step.py"
    path.write_text(STEP_SRC)
    want = _load(path).single()
    port = _free_port()
    spawn_ranks(lambda r: [sys.executable, str(path), str(r), "2", str(port), str(workdir)], 2)
    infos = [json.loads((workdir / f"r{r}.json").read_text()) for r in range(2)]
    return infos, want, workdir


@pytest.mark.parametrize("steps", [1, STEPS])
def test_fsdp_step_equals_the_single_process_step(fsdp_run, steps):
    infos, want, workdir = fsdp_run
    i = steps - 1
    got = infos[0]["metrics"][i]
    assert got == infos[1]["metrics"][i]
    assert got["loss"] == pytest.approx(want[i][0]["loss"], rel=1e-5)
    assert got["grad_norm"] == pytest.approx(want[i][0]["grad_norm"], rel=1e-4)
    for n, v in want[i][1].items():
        full = [np.load(workdir / f"r{r}.s{i}.p.{n}.npy") for r in range(2)]
        assert np.array_equal(full[0], full[1]), n
        for s in range(steps):  # every step's gradients
            g, wg = np.load(workdir / f"r0.s{s}.g.{n}.npy"), want[s][2][n]
            assert np.abs(g - wg).max() <= 1e-5 * max(np.abs(wg).max(), 1e-30), (s, n)
        bound = sum(_param_bound(want[s][2][n]) for s in range(steps))
        assert (np.abs(full[0] - v) <= bound).all(), (n, np.abs(full[0] - v).max())


def test_fsdp_shards_between_steps(fsdp_run):
    """After every step each rank holds 1/2 of every sharded tensor, and its
    AdamW moments lie on those shards."""
    infos, want, _ = fsdp_run
    specs = infos[0]["specs"]
    assert any("data" in s for s in specs.values())
    for info in infos:
        for local, moments in zip(info["local"], info["moments"]):
            for n, v in want[0][1].items():
                shape = list(v.shape)
                assert moments[n] == [local[n], local[n]], n
                if "data" in specs[n]:
                    d = specs[n].index("data")
                    assert local[n][d] * 2 == shape[d], n
                    assert local[n][:d] + local[n][d + 1:] == shape[:d] + shape[d + 1:], n
                else:
                    assert local[n] == shape, n


def test_fsdp_step_collectives(fsdp_run):
    """Each step issues one all-gather and one reduce-scatter over the data
    group (the default one here), and otherwise the collectives of the
    unplaced step under the same rows and one all-reduce more, the sharded
    gradients' squares of the pre-clip norm (as ``tp``'s shards'); nothing
    drives a collective from a hook."""
    infos, _, _ = fsdp_run
    for info in infos:
        plain = info["plain_counts"]
        want = dict(plain, **{"all_gather_into_tensor:world": 1,
                              "reduce_scatter_tensor:world": 1,
                              "all_reduce:world": plain["all_reduce:world"] + 1})
        assert info["counts"] == [want] * STEPS, (info["counts"], want)
        assert info["hooks"] == 0 and info["fsdp_modules"] == []
