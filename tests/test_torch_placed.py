"""Every program of the port reads a placed model whole, on the CPU: the
MoE and MAE steps on an FSDP placement, the placed eval forward
(``parallel.fsdp_forward``) and checkpoints of a placed model
(``ckpt.io``), against the JAX package and the port's single process.

Two worlds of gloo ranks (child processes, spawned once for the module)
run side by side while the parent computes the JAX side and the port's
single process. Weights are JAX-built and carried with
``module_from_numpy`` (the MAE's are drawn by the port from a seed).

- 2 ranks:
  - ``moe``: uit_xs_moe (depth 2, 4 experts, top-2, 1 s clips, 37 classes)
    placed by ``fsdp_shard_params``, three ``make_moe_train_step`` steps
    (AdamW) on the ranks' rows of three B=4 batches (one routing group
    spans both ranks);
  - ``mae``: the MAE (uit_xxxs encoder, depth 1, decoder depth 1, 160
    frames) placed the same way, three ``make_mae_step`` steps with a fixed
    ``noise=`` (so no draw differs);
  - ``forward``: uit_xxxs (depth 2) placed, ``fsdp_forward`` of
    ``models.apply`` on B=8, one all-gather of the shards a call; again
    with the card's dispatch forced (``GridMesh.capturable`` true,
    ``graphed`` recording): the body handed to ``graphed`` with the ranks'
    capture agreement, no host read of a device value, bitwise the eager
    route; ``models.apply`` and ``make_eval_step`` on the placed model
    raise a ``ValueError`` naming ``fsdp_forward``;
  - ``ckpt_fsdp``, ``ckpt_tp`` (FSDP over 2 ranks; TP 1x2): the placed
    model's ``save_checkpoint`` before any step; after one weak step with
    the EMA, ``save_checkpoint(named_params=EMA)`` against the file that
    one process writes from an unplaced model given the same values
    (``tp.gather_params``), bitwise; ``save_training_state``, a fresh
    placement, ``load_training_state``, one step: bitwise the step of the
    run that never stopped.
- 4 ranks: ``forward_hybrid`` and ``ckpt_hybrid``, hybrid FSDP x TP 2x2.

Gates: each step against the port's single process from the same state
(the ranks' whole parameters, BN statistics and AdamW moments after the
step before), at tests/test_torch_fsdp.py's: loss 1e-5 relative, pre-clip
norm 1e-4 relative, gradients 1e-5 of each tensor's largest, parameters
5e-5 plus what the gradient gate can move the Adam step. So each step's
arithmetic is held alone, and a stale gather shows in its gradients. (Run
free, Adam turns the roundings of near-zero gradients into parameter gaps
of up to 1.8e-5 after the first step, which move the next steps'
gradients by up to 4.6e-5 of a tensor's largest: not the step's fault.)
The steps draw nothing, so the ranks' ReLU signs are the single
process's unless an input lies within rounding of 0, which the gradient
gate would show. The MoE step against JAX's
``make_moe_train_step`` jitted under ``fsdp_shard_params`` on two host
devices: each step's loss 1e-5 relative, the parameters after the first
step within the bound of JAX's gradients, after the third within 1e-4
plus the bound summed over the port's steps (as tests/
test_torch_model_parallel.py's three hybrid steps). The forwards against
JAX's ``models.apply`` jitted on the placed params at 2e-5 in
probabilities (``test_torch_model_parallel.py:test_forward_matches_jax``).
The checkpoints' arrays equal JAX's ``save_checkpoint`` of the same
placement and the unplaced file bitwise, and load with ``load_model`` in
this process.
"""

import importlib.util
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh as JaxMesh
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from test_torch_parallel import REPO, _flat, _free_port, _param_bound
from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu import parallel as jax_parallel
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save_checkpoint
from uit_mobile_tpu.train.pretrain import MAEConfig

DEADLINE_S = 300
DENSE = ("uit_xxxs", dict(outputdim=37, target_length=102, depth=2))
MOE = ("uit_xs_moe", dict(outputdim=37, target_length=102, depth=2, n_experts=4))
MAE_ENC = dict(outputdim=537, target_length=160, depth=1)  # uit_xxxs
MOE_WEIGHT_DECAY = 1e-4  # optax.adamw's default, JAX's MoE test optimizer
STEPS = 3

RANK_SRC = r'''
"""The cases of one world as one rank: ``python ranks.py RANK WORLD PORT DIR``;
imported by the parent for the single process (``moe``, ``mae`` with no rows)."""
import collections
import contextlib
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from uit_mobile_tpu_torch import models, parallel
from uit_mobile_tpu_torch.ckpt import (load_training_state, save_checkpoint,
                                       save_training_state)
from uit_mobile_tpu_torch.ckpt.convert import module_from_numpy, unflatten_tree
from uit_mobile_tpu_torch.parallel import multihost
from uit_mobile_tpu_torch.parallel.rows import Rows
from uit_mobile_tpu_torch.parallel.tp import gather_params
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train.steps import find_ema_params, make_eval_step, wrap_optimizer

torch.set_num_threads(1)
STEPS = 3
COUNTS = collections.Counter()
SPEC = {}


def count_collectives():
    """Count this rank's collectives by name into COUNTS."""
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor"):
        def wrapped(*a, _orig=getattr(dist, name), _name=name, **k):
            COUNTS[_name] += 1
            return _orig(*a, **k)

        setattr(dist, name, wrapped)


def cfg_of(key):
    name, kw = SPEC["models"][key]
    return models.get_model_config(name, **kw)


def module_of(key, data):
    flat = {k[len(key) + 1:]: v for k, v in data.items() if k.startswith(key + ".")}
    p = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("p.")}, ".")
    s = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("s.")}, ".")
    return module_from_numpy(cfg_of(key), p, s, "cpu")


def mae_cfg():
    enc = models.get_model_config("uit_xxxs", **SPEC["mae_encoder"])
    return mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=1)


def recording(opt):
    """Each micro-step's gradients as the update takes them."""
    grads, update = [], opt.device_update

    def recorded(g, kind, row):
        grads.append([v.detach().clone() for v in g])
        return update(g, kind, row)

    opt.device_update = recorded
    return grads


def fsdp(model):
    return parallel.fsdp_shard_params(parallel.process_mesh("cpu"), model)[0]


def whole(model, tensors=None):
    """Every parameter (or ``tensors`` placed like them) whole, on the CPU."""
    if getattr(model, "shards", None):
        return gather_params(model, tensors)
    src = dict(model.named_parameters()) if tensors is None else tensors
    return {k: v.detach().clone() for k, v in src.items()}


def steps(kind, data, rows=None, sl=slice(None), placed=False, start=None):
    """The case's STEPS steps -> {'loss<i>', 'grad_norm<i>', and after step i
    the whole tensors 'p<i>.<name>' (parameters), 'g<i>.<name>' (its
    gradients), 'm<i>.<j>.<name>' (AdamW's moments), 's<i>.<name>' (BN
    statistics)}, and on a placed model 'sharded' (the count of split
    parameters) and 'no_rows' (its step refused without rows). ``start``:
    such a result; step i > 0 then starts from its state after step i - 1."""
    if kind == "moe":
        cfg, model = cfg_of("moe"), module_of("moe", data)
        spec = build_optimizer("AdamW", 1e-3, weight_decay=SPEC["moe_weight_decay"])
    else:
        cfg = mae_cfg()
        model, spec = mae.init(cfg, torch.Generator().manual_seed(4)), build_optimizer(
            "AdamW", 1e-3, weight_decay=1e-8)
    out = {}
    if placed:
        model = fsdp(model)
        out["sharded"] = np.asarray(len(model.shards))
        opt, _ = parallel.sharded_opt_init(spec, model)
    else:
        opt = spec.init(model)
    build = (lambda r: parallel.make_moe_train_step(cfg, model, opt, rows=r)) if kind == "moe" \
        else (lambda r: mae.make_mae_step(cfg, model, opt, rows=r))
    if placed:
        try:
            build(None)
            out["no_rows"] = np.asarray(False)
        except ValueError as e:
            out["no_rows"] = np.asarray("rows=" in str(e))
    step = build(rows)
    grads = recording(opt)
    for i in range(STEPS):
        if start is not None and i > 0:
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(torch.from_numpy(start[f"p{i - 1}.{n}"]))
                for n, b in model.named_buffers():
                    b.copy_(torch.from_numpy(start[f"s{i - 1}.{n}"]))
                for j, moment in enumerate(opt.moments):
                    for n, t in zip(opt.names, moment):
                        t.copy_(torch.from_numpy(start[f"m{i - 1}.{j}.{n}"]))
        wav = torch.from_numpy(data[f"{kind}_wav{i}"][sl])
        if kind == "moe":
            m = step(wav, torch.from_numpy(data[f"moe_tgt{i}"][sl]))
            out[f"loss{i}"], out[f"grad_norm{i}"] = m["total_loss"].item(), m["grad_norm"].item()
        else:
            out[f"loss{i}"] = step(wav, None, torch.from_numpy(data[f"mae_noise{i}"][sl])).item()
        out.update({f"p{i}.{n}": t.numpy() for n, t in whole(model).items()})
        out.update({f"g{i}.{n}": t.numpy()
                    for n, t in whole(model, dict(zip(opt.names, grads[i]))).items()})
        for j, moment in enumerate(opt.moments):
            out.update({f"m{i}.{j}.{n}": t.numpy()
                        for n, t in whole(model, dict(zip(opt.names, moment))).items()})
        out.update({f"s{i}.{n}": b.numpy().copy() for n, b in model.named_buffers()})
    return {k: np.asarray(v) for k, v in out.items()}


class HostReads(TorchDispatchMode):
    """Counts host reads of a device value (``_local_scalar_dense``)."""

    def __init__(self, log):
        super().__init__()
        self.log = log

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            self.log["host_reads"] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def card_branch(log):
    """The card's dispatch forced on these CPU ranks: ``GridMesh.capturable``
    true, ``graphed`` recording what it is handed (the body then runs under
    HostReads)."""
    from uit_mobile_tpu_torch.ops import graphs
    from uit_mobile_tpu_torch.parallel import mesh as mesh_mod

    def fake_graphed(fn, device, agree=None):
        log["handed"] += 1
        log["agreed"] += agree is not None

        def run(*args):
            with HostReads(log):
                return fn(*args)

        return run

    saved = graphs.graphed, mesh_mod.GridMesh.capturable
    graphs.graphed = fake_graphed
    mesh_mod.GridMesh.capturable = property(lambda self: True)
    try:
        yield
    finally:
        graphs.graphed, mesh_mod.GridMesh.capturable = saved


def place(route, model, world):
    """-> (placed model, its mesh, whether the step takes rows of the batch)."""
    if route == "fsdp":
        return fsdp(model), parallel.process_mesh("cpu"), True
    if route == "tp":
        mesh = parallel.make_grid_mesh({"data": 1, "model": world}, device="cpu")
        return parallel.shard_params(mesh, model)[0], mesh, False
    mesh = parallel.make_grid_mesh({"data": 2, "model": 2}, device="cpu")
    return parallel.hybrid_shard_params(mesh, model)[0], mesh, True


def forward(route, data, world):
    """The placed eval forward of the dense model, counted; the refusals;
    the card's branch forced."""
    cfg = cfg_of("dense")
    model, mesh, _ = place(route, module_of("dense", data), world)
    wav = torch.from_numpy(data["fwd_wav"])
    apply = lambda m, w: models.apply(cfg, m, w)  # noqa: E731
    fn = parallel.fsdp_forward(apply, mesh, model)
    COUNTS.clear()
    probs = fn(wav)
    out = {"probs": probs.numpy(), "counts": json.dumps(dict(COUNTS)),
           "eager_only": np.asarray(fn.graphs is None)}
    for name, call in (("apply", lambda: models.apply(cfg, model, wav[:2])),
                       ("eval_step", lambda: make_eval_step(cfg)(model, wav[:2]))):
        try:
            call()
            out[f"refused_{name}"] = ""
        except ValueError as e:
            out[f"refused_{name}"] = str(e)
    log = collections.Counter()
    with card_branch(log):
        forced = parallel.fsdp_forward(apply, mesh, model)
        out["forced"] = forced(wav).numpy()
        out["forced_again"] = forced(wav).numpy()
    out["forced_log"] = json.dumps(dict(log))
    return out


def checkpoints(route, data, world, rank, workdir):
    """The placed model's checkpoints (module docstring) -> the bitwise
    checks of its resume."""
    cfg = cfg_of("dense")
    # FSDP: this rank's rows of the batch; TP 1x2: every rank the whole batch
    share = multihost.host_local_batch_slice(len(data["ck_wav0"])) if route == "fsdp" \
        else slice(None)

    def fresh():
        model, _, _ = place(route, module_of("dense", data), world)
        spec = wrap_optimizer(build_optimizer("AdamW", 1e-3, weight_decay=1e-8), ema_decay=0.9)
        opt, _ = parallel.sharded_opt_init(spec, model)
        return model, opt

    def stepper(model, opt):
        rows = Rows([share.stop - share.start], "cpu") if route == "fsdp" else None
        step = make_train_step(cfg, model, opt, rows=rows)
        return lambda i: step({k: torch.from_numpy(data[f"ck_{k}{i}"][share])
                               for k in ("wav", "target")})

    model, opt = fresh()
    save_checkpoint(f"{workdir}/{route}.init.npz", model, cfg)
    if route == "hybrid":
        return {}
    step = stepper(model, opt)
    step(0)
    ema = find_ema_params(opt)
    save_checkpoint(f"{workdir}/{route}.ema.npz", model, cfg, named_params=ema)
    values, ema_values = whole(model), whole(model, ema)
    if rank == 0:  # one process, an unplaced model holding the same values
        plain = models.build(cfg, torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():
            for n, p in plain.named_parameters():
                p.copy_(values[n])
            for (n, b), (_, v) in zip(plain.named_buffers(), model.named_buffers()):
                b.copy_(v)
        save_checkpoint(f"{workdir}/{route}.ema_plain.npz", plain, cfg, named_params=ema_values)
    save_training_state(f"{workdir}/{route}.state.npz", model, opt, cfg, extra={"step": 1})
    went_on = step(1)
    model2, opt2 = fresh()
    _, extra = load_training_state(f"{workdir}/{route}.state.npz", model2, opt2)
    resumed = stepper(model2, opt2)(1)
    same = {"metrics": all(torch.equal(went_on[k], resumed[k]) for k in went_on),
            "params": all(torch.equal(a, b) for a, b in zip(model.parameters(),
                                                            model2.parameters())),
            "buffers": all(torch.equal(a, b) for a, b in zip(model.buffers(), model2.buffers())),
            "opt": all(torch.equal(a, b) for a, b in zip(opt.state_leaves(),
                                                         opt2.state_leaves())),
            "extra": extra == {"step": 1}}
    return {"resume": json.dumps(same),
            "local_shapes": json.dumps({n: list(p.shape) for n, p in model.named_parameters()})}


if __name__ == "__main__":
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    SPEC.update(json.load(open(f"{workdir}/spec.json")))
    count_collectives()
    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device="cpu",
                         timeout=120)
    data = dict(np.load(f"{workdir}/data.npz"))
    if world == 2:
        for kind, B in (("moe", len(data["moe_wav0"])), ("mae", len(data["mae_wav0"]))):
            sl = multihost.host_local_batch_slice(B)
            np.savez(f"{workdir}/{kind}.r{rank}.npz",
                     **steps(kind, data, Rows([B // world], "cpu"), sl, placed=True))
        np.savez(f"{workdir}/forward_fsdp.r{rank}.npz", **forward("fsdp", data, world))
        for route in ("fsdp", "tp"):
            np.savez(f"{workdir}/ckpt_{route}.r{rank}.npz",
                     **checkpoints(route, data, world, rank, workdir))
    else:
        np.savez(f"{workdir}/forward_hybrid.r{rank}.npz", **forward("hybrid", data, world))
        checkpoints("hybrid", data, world, rank, workdir)
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)
'''


def _jax_cfg(spec):
    name, kw = spec
    return jax_models.get_model_config(name, **kw)


def _jax_mesh(shape: dict):
    n = int(np.prod(list(shape.values())))
    return JaxMesh(np.asarray(jax.devices()[:n]).reshape(list(shape.values())), tuple(shape))


def _data():
    """JAX-built weights ('dense.', 'moe.' flat keys) and every batch."""
    params, data = {}, {}
    for key, spec in (("dense", DENSE), ("moe", MOE)):
        p, s = jax.tree.map(np.asarray, jax.jit(jax_models.build, static_argnums=0)(
            _jax_cfg(spec), jax.random.key(0)))
        params[key] = (p, s)
        data.update(_flat(p, f"{key}.p."), **_flat(s, f"{key}.s."))
    r = np.random.default_rng(17)
    n_patches = MAEConfig(jax_models.get_model_config("uit_xxxs", **MAE_ENC)).num_patches
    for i in range(STEPS):
        data[f"moe_wav{i}"] = (r.standard_normal((4, 16000)) * 0.1).astype(np.float32)
        data[f"moe_tgt{i}"] = (r.random((4, 37)) < 0.2).astype(np.float32)
        data[f"mae_wav{i}"] = (r.standard_normal((4, 160 * 160)) * 0.1).astype(np.float32)
        data[f"mae_noise{i}"] = r.random((4, n_patches)).astype(np.float32)
    for i in range(2):
        data[f"ck_wav{i}"] = (r.standard_normal((4, 16000)) * 0.1).astype(np.float32)
        data[f"ck_target{i}"] = (r.random((4, 37)) < 0.2).astype(np.float32)
    data["fwd_wav"] = (r.standard_normal((8, 16000)) * 0.1).astype(np.float32)
    return params, data


def _jax_moe_steps(params, data):
    """JAX's MoE step jitted under fsdp_shard_params on two host devices,
    STEPS steps -> (losses, flat params after each, flat gradients of the
    first: AdamW's first moment after it / 0.1)."""
    cfg = _jax_cfg(MOE)
    p, s = params["moe"]
    mesh = _jax_mesh({"data": 2})
    p, p_sh = jax_parallel.fsdp_shard_params(mesh, jax.tree.map(jnp.asarray, p))
    opt = optax.adamw(1e-3, weight_decay=MOE_WEIGHT_DECAY)
    o, o_sh = jax_parallel.sharded_opt_init(opt, p)
    repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    run = jax.jit(jax_parallel.make_moe_train_step(cfg, opt),
                  in_shardings=(p_sh, repl, o_sh, rows, rows, repl),
                  out_shardings=(p_sh, repl, o_sh, repl))
    s = jax.device_put(jax.tree.map(jnp.asarray, s), repl)
    losses, flat_p, grads = [], [], None
    for i in range(STEPS):
        wav = jax.device_put(jnp.asarray(data[f"moe_wav{i}"]), rows)
        tgt = jax.device_put(jnp.asarray(data[f"moe_tgt{i}"]), rows)
        p, s, o, m = run(p, s, o, wav, tgt, jax.random.key(11))
        losses.append(float(m["total_loss"]))
        flat_p.append(_flat(p, ""))
        if i == 0:
            grads = _flat(jax.tree.map(lambda mu: mu / 0.1, o[0].mu), "")
    return losses, flat_p, grads


def _jax_placements(params, wav, workdir):
    """JAX's forward jitted on the FSDP (2 devices) and hybrid (2x2)
    placements of the dense model, and its save_checkpoint of the FSDP, TP
    (1x2) and hybrid placements -> {'forward_fsdp', 'forward_hybrid'}."""
    cfg = _jax_cfg(DENSE)
    p, s = (jax.tree.map(jnp.asarray, t) for t in params["dense"])
    wav = jnp.asarray(wav)
    places = {
        "fsdp": lambda: jax_parallel.fsdp_shard_params(_jax_mesh({"data": 2}), p)[0],
        "tp": lambda: jax_parallel.shard_params(_jax_mesh({"data": 1, "model": 2}), p)[0],
        "hybrid": lambda: jax_parallel.hybrid_shard_params(
            _jax_mesh({"data": 2, "model": 2}), p)[0],
    }
    out = {}
    for route, placed in places.items():
        pp = placed()
        jax_save_checkpoint(workdir / f"{route}.jax.npz", pp, s, cfg)
        if route != "tp":
            out[f"forward_{route}"] = np.asarray(jax.jit(
                lambda q, t, w: jax_models.apply(cfg, q, t, w))(pp, s, wav))
    return out


def _load_ranks_module(path):
    spec = importlib.util.spec_from_file_location("placed_ranks", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Both worlds' cases, the JAX side and the single process computed
    while they run -> (ranks' outputs by case, JAX's, single's, workdir)."""
    import torch

    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("placed")
    params, data = _data()
    np.savez(workdir / "data.npz", **data)
    spec = {"models": {"dense": DENSE, "moe": MOE}, "mae_encoder": MAE_ENC,
            "moe_weight_decay": MOE_WEIGHT_DECAY}
    (workdir / "spec.json").write_text(json.dumps(spec))
    path = workdir / "ranks.py"
    path.write_text(RANK_SRC)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for world_size in (2, 4):
        port = _free_port()
        procs += [subprocess.Popen([sys.executable, str(path), str(r), str(world_size),
                                    str(port), str(workdir)], stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True, env=env)
                  for r in range(world_size)]
    t_end = time.monotonic() + DEADLINE_S
    try:
        jax_side = _jax_placements(params, data["fwd_wav"], workdir)
        jax_side["moe"] = _jax_moe_steps(params, data)
        outs = [p.communicate(timeout=max(1.0, t_end - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    worlds = [2, 2, 4, 4, 4, 4]
    for r, (p, out, w) in enumerate(zip(procs, outs, worlds)):
        assert p.returncode == 0, f"a rank of the {w}-rank world failed:\n{out}"
    names = {2: ["moe", "mae", "forward_fsdp", "ckpt_fsdp", "ckpt_tp"], 4: ["forward_hybrid"]}
    ranks = {name: [dict(np.load(workdir / f"{name}.r{r}.npz")) for r in range(w)]
             for w, ns in names.items() for name in ns}
    # the single process, each step from the ranks' state after the one before
    mod = _load_ranks_module(path)
    mod.SPEC.update(spec)
    single = {kind: mod.steps(kind, data, start=ranks[kind][0]) for kind in ("moe", "mae")}
    return ranks, jax_side, single, workdir


@pytest.mark.parametrize("kind", ["moe", "mae"])
@pytest.mark.parametrize("step", range(STEPS))
def test_placed_step_equals_the_single_process_step(world, kind, step):
    """Step ``step`` of the ranks against the single process's from the same
    state, at the gates of tests/test_torch_fsdp.py."""
    ranks, _, single, _ = world
    got, want, i = ranks[kind][0], single[kind], step
    assert int(got["sharded"]) > 0 and bool(got["no_rows"])
    for k, v in got.items():  # every rank ends alike
        np.testing.assert_array_equal(ranks[kind][1][k], v, err_msg=k)
    assert float(got[f"loss{i}"]) == pytest.approx(float(want[f"loss{i}"]), rel=1e-5)
    if f"grad_norm{i}" in want:
        assert float(got[f"grad_norm{i}"]) == pytest.approx(float(want[f"grad_norm{i}"]),
                                                            rel=1e-4)
    for n in (k[len("p0."):] for k in want if k.startswith("p0.")):
        g, wg = got[f"g{i}.{n}"], want[f"g{i}.{n}"]
        assert np.abs(g - wg).max() <= 1e-5 * max(np.abs(wg).max(), 1e-30), n
        d = np.abs(got[f"p{i}.{n}"] - want[f"p{i}.{n}"])
        assert (d <= _param_bound(wg)).all(), (n, d.max())


def test_placed_moe_step_matches_jax(world):
    ranks, jax_side, single, _ = world
    got, (losses, params, grads) = ranks["moe"][0], jax_side["moe"]
    for i, loss in enumerate(losses):
        assert float(got[f"loss{i}"]) == pytest.approx(loss, rel=1e-5), i
    for n, v in params[0].items():
        bound = _param_bound(grads[n], eps=1e-8)
        assert (np.abs(got[f"p0.{n}"] - v) <= bound).all(), n
    for n, v in params[-1].items():
        bound = 1e-4 + sum(_param_bound(single["moe"][f"g{s}.{n}"]) for s in range(STEPS))
        assert (np.abs(got[f"p{STEPS - 1}.{n}"] - v) <= bound).all(), n


@pytest.mark.parametrize("route", ["fsdp", "hybrid"])
def test_placed_forward_matches_jax(world, route):
    ranks, jax_side, _, _ = world
    per = ranks[f"forward_{route}"]
    for other in per[1:]:
        np.testing.assert_array_equal(other["probs"], per[0]["probs"])
    np.testing.assert_allclose(per[0]["probs"], jax_side[f"forward_{route}"], atol=2e-5, rtol=0)
    for r in per:
        # one all-gather of the shards a call; a CPU mesh runs eagerly
        assert json.loads(str(r["counts"])).get("all_gather_into_tensor") == 1
        assert bool(r["eager_only"])


@pytest.mark.parametrize("route", ["fsdp", "hybrid"])
def test_placed_forward_card_branch_is_the_eager_route(world, route):
    for r in world[0][f"forward_{route}"]:
        log = json.loads(str(r["forced_log"]))
        assert log["handed"] == 1 and log["agreed"] == 1 and log.get("host_reads", 0) == 0
        np.testing.assert_array_equal(r["forced"], r["probs"])
        np.testing.assert_array_equal(r["forced_again"], r["probs"])


@pytest.mark.parametrize("call", ["apply", "eval_step"])
def test_unwrapped_forward_on_a_placed_model_names_the_placed_forward(world, call):
    for route in ("fsdp", "hybrid"):
        for r in world[0][f"forward_{route}"]:
            msg = str(r[f"refused_{call}"])
            assert "fsdp_forward" in msg and "shards" in msg, (route, msg)


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k.startswith(("params/", "state/", "opt/"))}


def _assert_same_file(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("route", ["fsdp", "tp", "hybrid"])
def test_placed_checkpoint_is_the_whole_model(world, route):
    """The placed model's file: JAX's save_checkpoint of the same placement
    and the carried weights, array for array; it loads in one process."""
    from uit_mobile_tpu_torch.ckpt import load_model

    _, _, _, workdir = world
    got = _arrays(workdir / f"{route}.init.npz")
    _assert_same_file(got, _arrays(workdir / f"{route}.jax.npz"))
    assert got["params/blocks/0/mlp/fc1/kernel"].shape == (128, 384)
    _, model, _ = load_model(workdir / f"{route}.init.npz", device="cpu")
    with np.load(workdir / "data.npz") as data:
        for n, p in model.named_parameters():
            np.testing.assert_array_equal(p.detach().numpy(), data[f"dense.p.{n}"])


@pytest.mark.parametrize("route", ["fsdp", "tp"])
def test_placed_ema_checkpoint_equals_the_unplaced_file(world, route):
    ranks, _, _, workdir = world
    _assert_same_file(_arrays(workdir / f"{route}.ema.npz"),
                      _arrays(workdir / f"{route}.ema_plain.npz"))
    local = json.loads(str(ranks[f"ckpt_{route}"][0]["local_shapes"]))
    whole = _arrays(workdir / f"{route}.ema.npz")
    assert any(list(whole["params/" + n.replace(".", "/")].shape) != s
               for n, s in local.items())  # the ranks held shards


@pytest.mark.parametrize("route", ["fsdp", "tp"])
def test_placed_training_state_resumes_bitwise(world, route):
    ranks, _, _, workdir = world
    for r in ranks[f"ckpt_{route}"]:
        assert json.loads(str(r["resume"])) == {"metrics": True, "params": True,
                                                "buffers": True, "opt": True, "extra": True}
    # the file holds the whole moments and EMA: a parameter's shape for each
    state = _arrays(workdir / f"{route}.state.npz")
    shapes = {tuple(v.shape) for k, v in state.items() if k.startswith("params/")}
    opt = [v for k, v in state.items() if k.startswith("opt/")]
    assert all(tuple(v.shape) in shapes for v in opt[1:])
