"""Model parallelism of the port (uit_mobile_tpu_torch.parallel: tp, fsdp's
hybrid, sp, pp, ep) against the JAX package on the CPU.

One world of 4 gloo ranks (child processes, spawned once) runs every case
on JAX-built weights carried with ``module_from_numpy``; each case builds
its own ``GridMesh`` over the 4 ranks, so S=1/2/4 and several 2-D shapes
share the world. The JAX side runs the JAX function on a mesh of the same
shape over 4 of the 8 virtual CPU devices (tests/conftest.py), while the
ranks work. Cases (uit_xxxs unless said; B=8 x 1 s unless said):

- TP forward (depth 2): 2x2, 2x2 and 1x4 with ``shard_attention`` (1x4
  cuts the 2 heads' packed qkv mid-head), 4x1, and a 36-class head
  sharded 1x4 (its gather);
- SP (depth 4): S=1 (data 4), S=2 (data 2), S=4, full attention, bfloat16,
  a 0.64 s clip (16 tokens);
- PP (depth 8): pipe 4 at M=4 and M=8, data 2 x pipe 2 at B=16;
- EP (uit_xs_moe, depth 2, 4 experts): data 2 x expert 2 (a routing group
  of 8 clips spans both data shards) and 1x4;
- steps (the weak step, AdamW, B=16): TP 2x2 against JAX's single-device
  step and the port's single process; hybrid FSDP x TP 2x2, one step and
  three in a row, and FSDP over 4 ranks, each ``make_train_step`` on the
  placed model, against JAX's step jitted under its placement
  (``hybrid_shard_params``, ``fsdp_shard_params``) and the port's single
  process (a gather one update old shows from the second step on); TP
  2x2 with ``shard_attention``, dropout, attention dropout, drop-path,
  mixup and clipping (GELU) against the port's single process (draws
  cannot be held against JAX's); EP 2x2 against the port's single process
  and the loss of JAX's replicated step.

Tolerances are JAX's own (tests/test_{tensor,hybrid,sequence,pipeline}_
parallel.py, test_moe.py): forwards 2e-5 in probabilities, bfloat16 5e-3;
steps: loss 1e-5; against the port's single process the gates of
tests/test_torch_parallel.py (loss 1e-5 relative, pre-clip norm 1e-4
relative, gradients within 1e-5 of each tensor's largest, parameters 5e-5
plus what that gradient gate can move Adam's first step); against JAX's
step the parameters within the same bound of JAX's gradients (three
steps: within 1e-4, JAX's own hybrid gate, and the bound summed over the
steps against the port's single process). Every rank ends with the same
outputs and parameters. The ranks count their
collectives by mesh axis (torch.distributed wrapped in each child), and
the counts of each forward are pinned. The spec trees equal JAX's key for
key, and the checks that refuse raise.

One case of each forward route with a 'data' axis (TP 2x2 with
attention, SP 2x2, PP 2x2, EP 2x2) and the TP, hybrid, FSDP and EP steps
run again with
the card's dispatch forced on the ranks (``GridMesh.capturable`` and
``train.steps._graphable`` true, ``graphed`` recording): each hands its
body to ``graphed`` with the ranks' capture agreement, the body reads no
device value on the host and builds no ``Rows`` after its first call, and
its outputs are bitwise the eager route's (so within the JAX gates above).
"""

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
from uit_mobile_tpu.train import make_train_step as jax_make_train_step
from uit_mobile_tpu.train.steps import build_optimizer as jax_build_optimizer
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree

WORLD = 4
DEADLINE_S = 300
MODELS = {
    "tp": ("uit_xxxs", dict(outputdim=37, target_length=102, depth=2)),
    "tp36": ("uit_xxxs", dict(outputdim=36, target_length=102, depth=2)),
    "aug": ("uit_xxxs", dict(outputdim=37, target_length=102, depth=2, act="gelu",
                             drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)),
    "sp": ("uit_xxxs", dict(outputdim=37, target_length=102)),
    "sp_full": ("uit_xxxs", dict(outputdim=37, target_length=102, attention_type="Attention")),
    "sp_bf16": ("uit_xxxs", dict(outputdim=37, target_length=102, compute_dtype="bfloat16")),
    "pp": ("uit_xxxs", dict(outputdim=37, target_length=102, depth=8)),
    "ep": ("uit_xs_moe", dict(outputdim=37, target_length=102, depth=2, n_experts=4)),
}
# name: (route, model, mesh, options, wav)
FORWARDS = {
    "tp_2x2": ("tp", "tp", {"data": 2, "model": 2}, {}, "w8"),
    "tp_2x2_attn": ("tp", "tp", {"data": 2, "model": 2}, {"shard_attention": True}, "w8"),
    "tp_1x4_attn": ("tp", "tp", {"data": 1, "model": 4}, {"shard_attention": True}, "w8"),
    "tp_4x1": ("tp", "tp", {"data": 4, "model": 1}, {}, "w8"),
    "tp_1x4_head36": ("tp", "tp36", {"data": 1, "model": 4}, {}, "w8"),
    "sp_s1": ("sp", "sp", {"data": 4, "seq": 1}, {"data_axis": "data"}, "w8"),
    "sp_s2": ("sp", "sp", {"data": 2, "seq": 2}, {"data_axis": "data"}, "w8"),
    "sp_s4": ("sp", "sp", {"seq": 4}, {}, "w8"),
    "sp_full": ("sp", "sp_full", {"seq": 4}, {}, "w4"),
    "sp_bf16": ("sp", "sp_bf16", {"seq": 4}, {}, "w4"),
    "sp_short": ("sp", "sp", {"seq": 4}, {}, "short"),
    "pp_4": ("pp", "pp", {"pipe": 4}, {}, "w8"),
    "pp_4_m8": ("pp", "pp", {"pipe": 4}, {"n_microbatches": 8}, "w8"),
    "pp_2x2": ("pp", "pp", {"data": 2, "pipe": 2}, {"data_axis": "data"}, "w16"),
    "ep_2x2": ("ep", "ep", {"data": 2, "expert": 2}, {}, "w8"),
    "ep_1x4": ("ep", "ep", {"data": 1, "expert": 4}, {}, "w8"),
}
# name: (route, model, mesh, options, wav, target classes)
STEPS = {
    "tp_step": ("tp", "tp", {"data": 2, "model": 2}, {}, "w16"),
    "tp_step_aug": ("tp", "aug", {"data": 2, "model": 2}, {"shard_attention": True}, "w16"),
    "hybrid_step": ("hybrid", "tp", {"data": 2, "model": 2}, {}, "w16"),
    "hybrid_step_3": ("hybrid", "tp", {"data": 2, "model": 2}, {"steps": 3}, "w16"),
    "fsdp_step": ("fsdp", "tp", {"data": 4}, {}, "w16"),
    "ep_step": ("ep", "ep", {"data": 2, "expert": 2}, {}, "w8"),
}
# the cases run again with the card's dispatch forced (card_branch)
FORCED = ("tp_2x2_attn", "sp_s2", "pp_2x2", "ep_2x2", "tp_step", "hybrid_step", "fsdp_step",
          "ep_step")
AUG_STEP = dict(mixup_alpha=0.5, max_grad_norm=1.0)
EP_WEIGHT_DECAY = 1e-4  # optax.adamw's default, JAX's EP test optimizer

RANK_SRC = r'''
"""Every case of the world as one rank: ``python ranks.py RANK WORLD PORT DIR``."""
import collections
import contextlib
import inspect
import json
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt.convert import module_from_numpy, unflatten_tree
from uit_mobile_tpu_torch import parallel
from uit_mobile_tpu_torch.parallel import multihost
from uit_mobile_tpu_torch.parallel.tp import gather_params
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

torch.set_num_threads(1)
COUNTS = collections.Counter()
AXES = {}


def _counting(name):
    orig = getattr(dist, name)
    sig = inspect.signature(orig)

    def wrapped(*a, **k):
        group = sig.bind_partial(*a, **k).arguments.get("group")
        COUNTS[name + ":" + AXES.get(id(group), "world" if group is None else "?")] += 1
        return orig(*a, **k)

    setattr(dist, name, wrapped)


for _name in ("all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter_tensor",
              "broadcast"):
    _counting(_name)
_batch = dist.batch_isend_irecv


def _p2p(ops):
    for op in ops:
        COUNTS[op.op.__name__ + ":" + AXES.get(id(op.group), "?")] += 1
    return _batch(ops)


dist.batch_isend_irecv = _p2p


def model_of(cfg, data, key):
    flat = {k[len(key) + 1:]: v for k, v in data.items() if k.startswith(key + ".")}
    p = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("p.")}, ".")
    s = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("s.")}, ".")
    return module_from_numpy(cfg, p, s, "cpu")


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
def card_branch():
    """The card's dispatch forced on these CPU ranks: ``GridMesh.capturable``
    and ``_graphable`` true, ``graphed`` recording what it is handed (the
    body then runs under HostReads), Rows builds logged by the call they
    fall in (0: before the first) -> the log."""
    from uit_mobile_tpu_torch.ops import graphs
    from uit_mobile_tpu_torch.parallel import mesh as mesh_mod
    from uit_mobile_tpu_torch.parallel.rows import Rows
    from uit_mobile_tpu_torch.train import steps as steps_mod

    log = {"handed": 0, "agreed": 0, "calls": 0, "host_reads": 0, "rows_built_at_call": []}

    def fake_graphed(fn, device, agree=None):
        log["handed"] += 1
        log["agreed"] += agree is not None

        def run(*args):
            log["calls"] += 1
            with HostReads(log):
                return fn(*args)

        return run

    init = Rows.__init__

    def counting_init(self, *args, **kwargs):
        log["rows_built_at_call"].append(log["calls"])
        init(self, *args, **kwargs)

    saved = graphs.graphed, mesh_mod.GridMesh.capturable, steps_mod._graphable
    graphs.graphed, Rows.__init__ = fake_graphed, counting_init
    mesh_mod.GridMesh.capturable = property(lambda self: True)
    steps_mod._graphable = lambda opt, rows: True
    try:
        yield log
    finally:
        graphs.graphed, mesh_mod.GridMesh.capturable, steps_mod._graphable = saved
        Rows.__init__ = init


def build_forward(case, cfg, model, mesh, opts):
    route = case["route"]
    if route == "tp":
        return parallel.tensor_parallel_forward(
            lambda m, w: models.apply(cfg, m, w), mesh, model, **opts)
    if route == "sp":
        return parallel.sequence_parallel_forward(cfg, model, mesh, **opts)
    if route == "pp":
        return parallel.pipeline_forward(cfg, model, mesh, **opts)
    return parallel.expert_parallel_forward(cfg, model, mesh, **opts)


def forward(case, cfg, model, mesh, opts, wav):
    fn = build_forward(case, cfg, model, mesh, opts)
    COUNTS.clear()
    probs = fn(torch.from_numpy(wav))
    return {"probs": probs.numpy()}


def step(case, cfg, model, mesh, opts, wav, target, again=False):
    """The case's steps (``opts['steps']``, default one) -> (outputs, local
    shapes); ``again``: one more step after the outputs are taken."""
    route = case["route"]
    opts = dict(opts)
    steps = opts.pop("steps", 1)
    local, rows = mesh.shard_rows(torch.from_numpy(wav), "data")
    tgt, _ = mesh.shard_rows(torch.from_numpy(target), "data")
    gen = torch.Generator().manual_seed(7)
    if route == "ep":
        model, _ = parallel.ep_shard_params(mesh, model)
        opt, _ = parallel.sharded_opt_init(
            build_optimizer("AdamW", 1e-3, weight_decay=case["weight_decay"]), model)
        fn = parallel.make_moe_train_step(cfg, model, opt, rows=rows)
        run = lambda: fn(local, tgt, gen)  # noqa: E731
        root_model = model
    else:
        if route == "hybrid":
            model, _ = parallel.hybrid_shard_params(mesh, model)
        elif route == "fsdp":
            model, _ = parallel.fsdp_shard_params(parallel.process_mesh("cpu"), model)
        else:
            model, _ = parallel.shard_params(mesh, model, **opts)
        root_model = model
        opt, _ = parallel.sharded_opt_init(build_optimizer("AdamW", 1e-3, weight_decay=1e-8),
                                          model)
        fn = make_train_step(cfg, model, opt, rows=rows, **case["step_kw"])
        run = lambda: fn({"wav": local, "target": tgt}, gen)  # noqa: E731
    for _ in range(steps):
        m = run()
    out = {"loss": np.asarray(m["total_loss"].item()),
           "grad_norm": np.asarray(m["grad_norm"].item())}
    params = gather_params(root_model)
    moments = gather_params(root_model, dict(zip(opt.names, opt.moments[0])))
    out.update({f"p.{k}": v.numpy() for k, v in params.items()})
    out.update({f"g.{k}": (v / 0.1).numpy() for k, v in moments.items()})
    out.update({f"s.{k}": v.numpy().copy() for k, v in root_model.named_buffers()})
    shapes = {n: [list(p.shape), list(mu.shape)]
              for (n, p), mu in zip(root_model.named_parameters(), opt.moments[0])}
    if again:
        run()
    return out, shapes


def forced(case, cfg, model, mesh, opts, wav, target):
    """The case with the card's dispatch forced (card_branch), the mesh's
    Rows built anew: a forward called twice, a step run twice -> (outputs,
    the log)."""
    mesh.rows.clear()
    with card_branch() as log:
        if case["kind"] == "forward":
            fn = build_forward(case, cfg, model, mesh, opts)
            probs = [fn(torch.from_numpy(wav)).numpy() for _ in range(2)]
            res = {"probs": probs[0], "probs_again": probs[1]}
        else:
            res, _ = step(case, cfg, model, mesh, opts, wav, target, again=True)
    return res, log


if __name__ == "__main__":
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device="cpu",
                         timeout=120)
    data = dict(np.load(f"{workdir}/data.npz"))
    report = {}
    for case in json.load(open(f"{workdir}/cases.json")):
        mesh = parallel.make_grid_mesh(case["mesh"], device="cpu")
        AXES.clear()
        AXES.update({id(g): a for a, g in mesh.groups.items()})
        cfg = models.get_model_config(case["model_name"], **case["model_kw"])
        model = model_of(cfg, data, case["model"])
        opts = case["opts"]
        if case["kind"] == "forward":
            res, shapes = forward(case, cfg, model, mesh, opts, data[case["wav"]]), None
        else:
            res, shapes = step(case, cfg, model, mesh, opts, data[case["wav"]],
                               data[case["wav"] + "_target"])
        np.savez(f"{workdir}/{case['name']}.r{rank}.npz", **res)
        report[case["name"]] = {"counts": dict(COUNTS), "coords": mesh.coords,
                                "shapes": shapes}
        if case["forced"]:
            res, log = forced(case, cfg, model_of(cfg, data, case["model"]), mesh, opts,
                              data[case["wav"]], data.get(case["wav"] + "_target"))
            np.savez(f"{workdir}/{case['name']}.forced.r{rank}.npz", **res)
            report[case["name"]]["forced"] = log
    json.dump(report, open(f"{workdir}/report.r{rank}.json", "w"))
    dist.destroy_process_group()
    print(f"DONE {rank}", flush=True)
'''


def _jax_cfg(key):
    name, kw = MODELS[key]
    return jax_models.get_model_config(name, **kw)


def _wavs():
    r = {}
    for key, (b, t, seed) in {"w4": (4, 16000, 3), "w8": (8, 16000, 0), "w16": (16, 16000, 2),
                              "short": (4, 10240, 5)}.items():
        r[key] = (np.random.default_rng(seed).standard_normal((b, t)) * 0.1).astype(np.float32)
        r[key + "_target"] = (np.random.default_rng(seed + 10).random((b, 37)) < 0.1
                              ).astype(np.float32)
    return r


def _jax_mesh(shape: dict):
    return JaxMesh(np.asarray(jax.devices()[:WORLD]).reshape(list(shape.values())),
                   tuple(shape))


def _jax_forward(name, params):
    route, key, shape, opts, wav_key = FORWARDS[name]
    cfg = _jax_cfg(key)
    p, s = params[key]
    wav = jnp.asarray(_wavs()[wav_key])
    mesh = _jax_mesh(shape)
    if route == "tp":
        fn = jax_parallel.tensor_parallel_forward(
            lambda pp, ss, w: jax_models.apply(cfg, pp, ss, w), mesh, p, s, **opts)
    elif route == "sp":
        fn = jax_parallel.sequence_parallel_forward(cfg, p, s, mesh, **opts)
    elif route == "pp":
        fn = jax_parallel.pipeline_forward(cfg, p, s, mesh, **opts)
    else:
        fn = jax_parallel.expert_parallel_forward(cfg, p, s, mesh)
    return np.asarray(fn(wav))


def _jax_step(name, params):
    """JAX's step -> (loss, flat params, flat gradients): the single-device
    step, or for the FSDP and hybrid cases the step jitted under their
    placement on a mesh of the case's shape, as many steps as the case."""
    route, key, shape, opts, wav_key = STEPS[name]
    cfg = _jax_cfg(key)
    p, s = params[key]
    data = _wavs()
    wav, tgt = jnp.asarray(data[wav_key]), jnp.asarray(data[wav_key + "_target"])
    if route == "ep":
        opt = optax.adamw(1e-3, weight_decay=EP_WEIGHT_DECAY)
        step = jax_parallel.make_moe_train_step(cfg, opt)
        new_p, _, new_o, m = jax.jit(step)(p, s, opt.init(p), wav, tgt, jax.random.key(11))
    else:
        opt = jax_build_optimizer("AdamW", 1e-3, weight_decay=1e-8)
        step, o, batch = jax_make_train_step(cfg, opt), opt.init(p), {"wav": wav, "target": tgt}
        if route in ("hybrid", "fsdp"):
            mesh = _jax_mesh(shape)
            place = (jax_parallel.hybrid_shard_params if route == "hybrid"
                     else jax_parallel.fsdp_shard_params)
            p, p_sh = place(mesh, p)
            o, o_sh = jax_parallel.sharded_opt_init(opt, p)
            repl, rows = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
            run = jax.jit(step, in_shardings=(p_sh, repl, o_sh, rows, repl),
                          out_shardings=(p_sh, repl, o_sh, repl))
            s, batch = jax.device_put(s, repl), jax.device_put(batch, rows)
        else:
            run = jax.jit(step)
        for _ in range(opts.get("steps", 1)):
            p, s, o, m = run(p, s, o, batch, jax.random.key(7))
        new_p, new_o = p, o
    return (float(m["total_loss"]), _flat(new_p, "p."),
            _flat(jax.tree.map(lambda mu: mu / 0.1, new_o[0].mu), "g."))


def _port_single(name, data):
    """The port's single-process step on the whole batch -> the ranks' keys."""
    import torch

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.parallel import make_moe_train_step
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    route, key, _, opts, wav_key = STEPS[name]
    name_, kw = MODELS[key]
    cfg = models.get_model_config(name_, **kw)
    flat = {k[len(key) + 1:]: v for k, v in data.items() if k.startswith(key + ".")}
    from uit_mobile_tpu_torch.ckpt.convert import module_from_numpy, unflatten_tree

    model = module_from_numpy(
        cfg, unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("p.")}, "."),
        unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("s.")}, "."), "cpu")
    wav, tgt = torch.from_numpy(data[wav_key]), torch.from_numpy(data[wav_key + "_target"])
    gen = torch.Generator().manual_seed(7)
    if route == "ep":
        opt = build_optimizer("AdamW", 1e-3, weight_decay=EP_WEIGHT_DECAY).init(model)
        m = make_moe_train_step(cfg, model, opt)(wav, tgt, gen)
    else:
        opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(model)
        step = make_train_step(cfg, model, opt, **_step_kw(name))
        grads, update = [], opt.device_update
        opt.device_update = lambda g, *plan: (grads.append([v.numpy().copy() for v in g]),
                                              update(g, *plan))[1]
        for _ in range(opts.get("steps", 1)):
            m = step({"wav": wav, "target": tgt}, gen)
    out = {"loss": m["total_loss"].item(), "grad_norm": m["grad_norm"].item()}
    if opts.get("steps", 1) > 1:  # the parameters' bound summed over the steps
        out.update({f"bound.{n}": sum(_param_bound(g[i]) for g in grads)
                    for i, n in enumerate(opt.names)})
    out.update({f"p.{n}": p.detach().numpy().copy() for n, p in model.named_parameters()})
    out.update({f"g.{n}": (mu / 0.1).numpy() for n, mu in zip(opt.names, opt.moments[0])})
    out.update({f"s.{n}": b.numpy().copy() for n, b in model.named_buffers()})
    return out


def _step_kw(name):
    return AUG_STEP if name == "tp_step_aug" else {}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case on 4 gloo ranks, JAX's side computed while they run ->
    (ranks' outputs, their reports, JAX's outputs)."""
    import torch

    torch.set_num_threads(1)
    workdir = tmp_path_factory.mktemp("mp")
    params, data = {}, _wavs()
    for key in MODELS:
        jcfg = _jax_cfg(key)
        p, s = jax.tree.map(np.asarray, jax.jit(jax_models.build, static_argnums=0)(
            jcfg, jax.random.key(0)))
        params[key] = (p, s)
        data.update(_flat(p, f"{key}.p."), **_flat(s, f"{key}.s."))
    np.savez(workdir / "data.npz", **data)
    cases = []
    for table, kind in ((FORWARDS, "forward"), (STEPS, "step")):
        for name, (route, key, shape, opts, wav) in table.items():
            cases.append({"name": name, "kind": kind, "route": route, "model": key,
                          "model_name": MODELS[key][0], "model_kw": MODELS[key][1],
                          "mesh": shape, "opts": opts, "wav": wav,
                          "step_kw": _step_kw(name), "weight_decay": EP_WEIGHT_DECAY,
                          "forced": name in FORCED})
    (workdir / "cases.json").write_text(json.dumps(cases))
    (workdir / "ranks.py").write_text(RANK_SRC)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(workdir / "ranks.py"), str(r), str(WORLD),
                               str(port), str(workdir)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for r in range(WORLD)]
    t_end = time.monotonic() + DEADLINE_S
    try:
        jax_side = {name: _jax_forward(name, params) for name in FORWARDS}
        jax_side.update({name: _jax_step(name, params) for name in STEPS
                         if name != "tp_step_aug"})
        single = {name: _port_single(name, data) for name in STEPS}
        outs = [p.communicate(timeout=max(1.0, t_end - time.monotonic()))[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    ranks = {name: [dict(np.load(workdir / f"{name}.r{r}.npz")) for r in range(WORLD)]
             for name in list(FORWARDS) + list(STEPS)}
    ranks.update({f"{name}.forced": [dict(np.load(workdir / f"{name}.forced.r{r}.npz"))
                                     for r in range(WORLD)] for name in FORCED})
    reports = [json.loads((workdir / f"report.r{r}.json").read_text()) for r in range(WORLD)]
    return ranks, reports, jax_side, single


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_matches_jax(world, name):
    ranks, _, jax_side, _ = world
    got = ranks[name][0]["probs"]
    for other in ranks[name][1:]:
        np.testing.assert_array_equal(other["probs"], got)
    atol = 5e-3 if "bf16" in name else 2e-5
    np.testing.assert_allclose(got, jax_side[name], atol=atol, rtol=0)


def _pp_counts(coords, S, M, data):
    s = coords["pipe"]
    c = {"all_reduce:pipe": 1}
    if s < S - 1:
        c["isend:pipe"] = M
    if s > 0:
        c["irecv:pipe"] = M
    if data:
        c.update({"all_reduce:data": 1, "all_gather:data": 1})
    return c


DATA2 = {"all_reduce:data": 1, "all_gather:data": 1}  # the clamp's max; the output
COUNTS = {
    "tp_2x2": {"all_reduce:model": 2, **DATA2},  # fc2 a block; the 37-class head whole
    "tp_2x2_attn": {"all_reduce:model": 4, "all_gather:model": 2, **DATA2},
    "tp_1x4_attn": {"all_reduce:model": 4, "all_gather:model": 2},
    "tp_4x1": dict(DATA2),  # model=1: no collective over 'model'
    "tp_1x4_head36": {"all_reduce:model": 2, "all_gather:model": 1},  # + the head's gather
    "sp_s1": dict(DATA2),  # S=1: no ring
    "sp_s2": {"isend:seq": 8, "irecv:seq": 8, "all_reduce:seq": 1, **DATA2},  # 2(S-1) x 4 blocks
    "sp_s4": {"isend:seq": 24, "irecv:seq": 24, "all_reduce:seq": 1},
    "sp_full": {"isend:seq": 24, "irecv:seq": 24, "all_reduce:seq": 1},
    "sp_bf16": {"isend:seq": 24, "irecv:seq": 24, "all_reduce:seq": 1},
    "sp_short": {"isend:seq": 24, "irecv:seq": 24, "all_reduce:seq": 1},
    # a block: the combine over 'expert', the routing choices and the mean
    # gate over 'data'
    "ep_2x2": {"all_reduce:expert": 2, "all_gather:data": 1, "all_reduce:data": 5},
    "ep_1x4": {"all_reduce:expert": 2},
}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_collectives_by_axis(world, name):
    _, reports, _, _ = world
    for rep in reports:
        got = rep[name]["counts"]
        if name.startswith("pp"):
            S = FORWARDS[name][2]["pipe"]
            M = FORWARDS[name][3].get("n_microbatches", S)
            want = _pp_counts(rep[name]["coords"], S, M, "data" in FORWARDS[name][2])
        else:
            want = COUNTS[name]
        assert got == want, (name, rep[name]["coords"], got)


def _gates(got, want, bound_grads):
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-4)
    for k, v in want.items():
        if k.startswith("g."):
            assert np.abs(got[k] - v).max() <= 1e-5 * max(np.abs(v).max(), 1e-30), k
        elif k.startswith("s."):
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
        elif k.startswith("p."):
            bound = want.get(f"bound.{k[2:]}", _param_bound(bound_grads[f"g.{k[2:]}"]))
            assert (np.abs(got[k] - v) <= bound).all(), (k, np.abs(got[k] - v).max())


@pytest.mark.parametrize("name", list(STEPS))
def test_step_equals_the_single_process_step(world, name):
    ranks, reports, _, single = world
    got = ranks[name][0]
    for other in ranks[name][1:]:
        diff = [k for k in got if not np.array_equal(got[k], other[k])]
        assert not diff, [(k, float(np.abs(got[k] - other[k]).max())) for k in diff]
    _gates(got, single[name], single[name])
    # each rank holds its shards, and its moments lie on them
    route, _, shape, _, _ = STEPS[name]
    axis = {"ep": "expert", "hybrid": "model", "tp": "model", "fsdp": "data"}[route]
    shapes = reports[0][name]["shapes"]
    whole = {k[2:]: v.shape for k, v in single[name].items() if k.startswith("p.")}
    key = "blocks.0.moe.fc1.kernel" if route == "ep" else "blocks.0.mlp.fc1.kernel"
    local, moment = shapes[key]
    assert moment == local
    n = np.prod(local) * shape[axis] * (shape["data"] if route == "hybrid" else 1)
    assert n == np.prod(whole[key]), (key, local, whole[key])


@pytest.mark.parametrize("name", [n for n in STEPS if n != "tp_step_aug"])
def test_step_matches_jax(world, name):
    ranks, _, jax_side, _ = world
    loss, params, grads = jax_side[name]
    got = ranks[name][0]
    assert abs(float(got["loss"]) - loss) < 1e-5
    if name == "ep_step":  # JAX's EP test holds the loss to the replicated step's
        return
    for k, v in params.items():
        bound = (1e-4 if STEPS[name][3].get("steps", 1) > 1  # JAX's hybrid gate
                 else _param_bound(grads[f"g.{k[2:]}"]))
        assert (np.abs(got[k] - v) <= bound).all(), (k, np.abs(got[k] - v).max())


@pytest.mark.parametrize("name", FORCED)
def test_card_branch_is_the_eager_route(world, name):
    """The case with the card's dispatch forced: on every rank its body went
    to ``graphed`` with the ranks' capture agreement, read no device value
    on the host and built no Rows after its first call, and its outputs
    (both calls of a forward) are bitwise the eager route's, so within the
    JAX gates of the tests above."""
    ranks, reports, jax_side, _ = world
    for r in range(WORLD):
        log = reports[r][name]["forced"]
        assert log["handed"] >= 1 and log["agreed"] == log["handed"], log
        assert log["calls"] == 2 and log["host_reads"] == 0, log
        assert max(log["rows_built_at_call"], default=0) <= 1, log
        got, want = ranks[f"{name}.forced"][r], ranks[name][r]
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        if name in FORWARDS:
            np.testing.assert_array_equal(got["probs_again"], want["probs"])
    got = ranks[f"{name}.forced"][0]
    if name in FORWARDS:
        np.testing.assert_allclose(got["probs"], jax_side[name], atol=2e-5, rtol=0)
    else:
        assert abs(float(got["loss"]) - jax_side[name][0]) < 1e-5


# ----------------------------------------------------------- single process

def _jax_params(key):
    params, _ = jax_models.build(_jax_cfg(key), jax.random.key(0))
    return params, flatten_tree(jax.tree.map(np.asarray, params), ".")


@pytest.mark.parametrize("shard_attention", [False, True])
def test_tp_param_specs_equal_jax(shard_attention):
    from uit_mobile_tpu_torch.parallel import tp_param_specs

    params, flat = _jax_params("tp")
    want = flatten_tree(jax_parallel.tp_param_specs(params, shard_attention=shard_attention),
                        ".")
    got = tp_param_specs(flat, shard_attention=shard_attention)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)
    assert got["blocks.0.mlp.fc1.kernel"] == (None, "model")
    assert got["blocks.0.mlp.fc2.bias"] == ()
    assert (got["blocks.0.attn.qkv.kernel"] == (None, "model")) == shard_attention


@pytest.mark.parametrize("shard_attention", [False, True])
@pytest.mark.parametrize("min_size", [1024, 100])
def test_hybrid_param_specs_equal_jax(shard_attention, min_size):
    from uit_mobile_tpu_torch.parallel import hybrid_param_specs

    params, flat = _jax_params("tp")
    want = flatten_tree(jax_parallel.hybrid_param_specs(
        params, min_size=min_size, shard_attention=shard_attention), ".")
    got = hybrid_param_specs(flat, min_size=min_size, shard_attention=shard_attention)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)
    assert got["blocks.0.mlp.fc1.kernel"] == ("data", "model")


def test_ep_param_specs_equal_jax():
    from uit_mobile_tpu_torch.parallel import ep_param_specs

    params, flat = _jax_params("ep")
    want = flatten_tree(jax_parallel.ep_param_specs(params), ".")
    got = ep_param_specs(flat)
    assert got.keys() == want.keys()
    assert all(got[k] == tuple(want[k]) for k in want)
    assert got["blocks.0.moe.fc2.bias"] == ("expert", None)
    assert got["blocks.0.moe.router.kernel"] == ()


def test_parallel_exports_every_name_of_jax():
    from uit_mobile_tpu_torch import parallel

    assert set(jax_parallel.__all__) <= set(parallel.__all__)
    assert all(callable(getattr(parallel, n)) or n == "multihost" for n in parallel.__all__)


def _grid(shape):
    """A GridMesh's shape alone: the checks run before any collective."""
    from uit_mobile_tpu_torch.parallel import GridMesh

    return GridMesh(shape, {a: 0 for a in shape}, {}, "cpu")


def test_refusals():
    import torch

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.parallel import (make_mesh_2d, pipeline_forward,
                                               sequence_parallel_forward, sharded_opt_init)
    from uit_mobile_tpu_torch.train import build_optimizer

    cfg = models.get_model_config("uit_xxxs", outputdim=37, target_length=102)
    model = models.build(cfg, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="5 sequence shards"):  # 24 tokens over 5
        sequence_parallel_forward(cfg, model, _grid({"seq": 5}))
    deep = models.get_model_config("uit_xxxs", outputdim=37, target_length=102, depth=8)
    with pytest.raises(ValueError, match="3 pipeline stages"):
        pipeline_forward(deep, model, _grid({"pipe": 3}))
    tfb = models.get_model_config("uit_xxxs", outputdim=37, target_length=102,
                                  mel_layout="tfb")
    with pytest.raises(ValueError, match="DP-only"):
        pipeline_forward(tfb, model, _grid({"pipe": 2}))
    with pytest.raises(ValueError, match="pooling='mean'"):
        sequence_parallel_forward(models.get_model_config(
            "uit_xxxs", outputdim=37, target_length=102, pooling="token"), model,
            _grid({"seq": 2}))
    with pytest.raises(ValueError, match="process group"):  # no process group here
        make_mesh_2d(1, 1, device="cpu")
    model.shard_specs = {"blocks.0.mlp.fc1.kernel": (None, "model")}
    with pytest.raises(ValueError, match="Adafactor"):
        sharded_opt_init(build_optimizer("Adafactor", 1e-3), model)


def test_moe_routing_groups_span_in_process_replicas():
    """The MoE's routing groups are the global batch's on the in-process
    data-parallel mesh too (``rows.ThreadGroup``): at B=8 one group of 8
    clips spans both replicas, whose routing choices meet in one all-reduce
    and whose forward equals the single forward on the whole batch."""
    import torch

    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.parallel import data_parallel_forward, make_mesh

    name, kw = MODELS["ep"]
    cfg = models.get_model_config(name, **kw)
    model = models.build(cfg, torch.Generator().manual_seed(0), "cpu")
    wav = torch.from_numpy(_wavs()["w8"])
    want = models.apply(cfg, model, wav)
    got = data_parallel_forward(lambda w: models.apply(cfg, model, w),
                                make_mesh(devices=["cpu", "cpu"]))(wav)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
