"""Data parallelism of the port (uit_mobile_tpu_torch.parallel) on the CPU.

2 and 4 gloo ranks in child processes each take their rows of one global
batch (``multihost.host_local_batch_slice``) and run one train step under
``parallel.rows``; the result must be the port's single-process step on
the whole batch, and, where the step draws nothing, JAX's step jitted over
the 8-virtual-device mesh (``tests/test_parallel.py:46-84``).

Cases (uit_xxxs, depth 1-2, 1 s clips; B=12 at 2 ranks so that each rank's
PSL half is odd, B=16 at 4 ranks):
- ``plain``: the weak step, no draws (JAX comparison);
- ``psl``: the PSL step (the teacher over the AudioSet half, JAX's
  ``[all audioset, all kws]`` order, clipping), no draws (JAX comparison);
- ``psl_aug`` / ``tfb_psl_aug``: the PSL step with mixup, Shift, Gain,
  PolarityInversion, time and frequency masks, dropout, attention dropout
  and drop-path, in the bft and the tfb layout (the teacher through
  'tfb_to_bft');
- ``sed`` (JAX comparison) and ``sed_aug``: the framewise step;
- ``mae`` (JAX's noise, drawn once for the global batch, as in
  tests/test_torch_pretrain.py; JAX comparison) and ``mae_gen`` (the noise
  from the step's generator).

Gates: against the port's single process (the step gates of
tests/test_torch_steps.py): loss 1e-5 relative, pre-clip gradient norm
1e-4 relative, gradients within 1e-5 of each tensor's largest, BN
statistics 1e-6, parameters 5e-5 plus the move the gradient gate allows
Adam's first step, lr * eps * dg / (|g| + eps)^2, over every element (the
summation order alone differs: a rank sums its rows, the group sums the
ranks; near a zero gradient Adam turns a rounding into up to lr); against
JAX's 8-device step, the JAX test's gates: loss 1e-5, parameters 5e-5.
Every rank ends with the same parameters, bit for bit; one rank in a
process group gives the single-process step bit for bit. Under ReLU a unit
whose input lies within float32 rounding of 0 may take the other side
between two summation orders and move fc1's whole gradient term (1.5e-2 of
the tensor's largest in a 4-rank SED step with draws). So the cases with
draws (``AUG_CASES``) hold those gates against the single process given
the ranks' ReLU signs (the MLP's ReLU replaced by the product with them),
and against the free single process the loss at 1e-5 and every flipped
sign on an input within 1e-5 of its call's largest |input| of 0. The
cases without draws hold every gate free. Random draws cannot be held
against JAX's (a JAX key and a torch.Generator draw different numbers, as
in tests/test_torch_augment.py): the JAX comparisons are the cases without
draws. Each child process is joined with a deadline and killed after it.
"""

import importlib.util
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P
from torch.utils._python_dispatch import TorchDispatchMode

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.parallel import make_mesh as jax_make_mesh
from uit_mobile_tpu.train import pretrain as jax_mae
from uit_mobile_tpu.train.steps import build_optimizer as jax_build_optimizer
from uit_mobile_tpu.train.steps import make_framewise_train_step as jax_framewise_step
from uit_mobile_tpu.train.steps import make_train_step as jax_make_train_step

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 240
MAE_KEY = jax.random.key(3)

CASES_SRC = r'''
"""One step of each case on one rank's rows (under a process group) or on
the whole batch; ``python cases.py rank world port workdir`` runs every
case as one rank."""
import json
import sys

import numpy as np
import torch

from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree, load_numpy, unflatten_tree
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.parallel.rows import Rows
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train.steps import make_framewise_train_step

torch.set_num_threads(1)
AUG = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)
AUG_CASES = ("psl_aug", "tfb_psl_aug", "sed_aug")
WAV_AUG = {"Shift": {"p": 0.5}, "Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}}
SED_WAV_AUG = {"Gain": {"p": 0.5}, "PolarityInversion": {"p": 0.5}}
SPEC_AUG = {"TimeMasking": {"time_mask_param": 20}, "FrequencyMasking": {"freq_mask_param": 8}}


def student_cfg(case):
    if case.startswith("mae"):
        enc = models.get_model_config("uit_xxxs", outputdim=537, target_length=160, depth=1)
        return mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=1)
    kw = dict(target_length=102)
    if case in ("plain", "psl"):
        return models.get_model_config("uit_xxxs", outputdim=37, depth=1, **kw)
    if case.startswith("sed"):
        return models.get_model_config("uit_xxxs", outputdim=10, depth=1, pooling="dm",
                                       **kw, **(AUG if case == "sed_aug" else {}))
    return models.get_model_config("uit_xxxs", outputdim=37, depth=2,
                                   mel_layout="tfb" if case.startswith("tfb") else "bft",
                                   **kw, **AUG)


def module(cfg, flat):
    """A module holding the flat numpy tree ``flat`` (JAX layout)."""
    p = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("p.")}, ".")
    s = unflatten_tree({k[2:]: v for k, v in flat.items() if k.startswith("s.")}, ".")
    shell = (mae.MAE(cfg) if isinstance(cfg, mae.MAEConfig)
             else models.build(cfg, torch.Generator().manual_seed(0), device="cpu"))
    return load_numpy(shell, p, s)


def relu_signs(record=None, impose=None):
    """Replace the encoder MLP's ReLU (models/common.py ACTIVATIONS): record
    each call's input into ``record``, or impose another run's signs,
    popped from ``impose`` (the gradient then follows them) -> the function
    that restores it."""
    from uit_mobile_tpu_torch.models import common

    orig = common.ACTIVATIONS["relu"]

    def relu(z):
        if impose is not None:
            return z * torch.from_numpy(impose.pop(0)).to(z.dtype)
        record.append(z.detach().numpy().copy())
        return orig(z)

    common.ACTIVATIONS["relu"] = relu
    return lambda: common.ACTIVATIONS.__setitem__("relu", orig)


def run(case, data, rows=None, sl=slice(None), record=None, impose=None):
    """-> {'loss', 'grad_norm', 'p.<name>', 's.<name>', 'g.<name>'} after one
    step of ``case`` on rows ``sl`` of the batch in ``data``; ``record`` /
    ``impose``: relu_signs."""
    watch = record is not None or impose is not None
    restore = relu_signs(record, impose) if watch else None
    try:
        return _run(case, data, rows, sl)
    finally:
        if restore is not None:
            restore()


def _run(case, data, rows, sl):
    cfg = student_cfg(case)
    model = module(cfg, {k[4:]: v for k, v in data.items() if k.startswith("stu.")})
    opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(model)
    wav = torch.from_numpy(data["wav"][sl])
    gen = torch.Generator().manual_seed(7)
    out = {}
    if case.startswith("mae"):
        noise = None if case == "mae_gen" else torch.from_numpy(data["noise"][sl])
        out["loss"] = mae.make_mae_step(cfg, model, opt, rows=rows)(wav, gen, noise)
    elif case.startswith("sed"):
        aug = case == "sed_aug"
        step = make_framewise_train_step(
            cfg, model, opt, max_grad_norm=1.0, rows=rows,
            wav_augment=parse_wavtransforms(SED_WAV_AUG if aug else {}),
            spec_augment=parse_spectransforms(SPEC_AUG if aug else {}))
        m = step({"wav": wav, "target": torch.from_numpy(data["target"][sl])}, gen)
        out.update(loss=m["total_loss"], grad_norm=m["grad_norm"])
    else:
        kw = {}
        if case != "plain":
            layout = cfg.mel_layout
            t_cfg = models.get_model_config("MobileNetV2", outputdim=17)
            teacher = module(t_cfg, {k[4:]: v for k, v in data.items() if k.startswith("tea.")})
            kw = dict(max_grad_norm=1.0, psl_cfg=t_cfg,
                      psl_model=teacher.eval().requires_grad_(False),
                      psl_split=len(data["wav"][sl]) // 2, distill_classes=10)
        if case in AUG_CASES:
            kw.update(mixup_alpha=0.5, wav_augment=parse_wavtransforms(WAV_AUG),
                      spec_augment=parse_spectransforms(SPEC_AUG, layout=layout),
                      frontend_fn=make_frontend_fn(cfg.frontend, layout=layout),
                      psl_frontend_fn=make_frontend_fn(t_cfg.frontend, layout="tfb_to_bft"))
        batch = {"wav": wav, "target": torch.from_numpy(data["target"][sl])}
        if case != "plain":  # [this rank's audioset rows, its kws rows]
            h = len(data["wav"]) // 2
            a, b = (sl.start or 0) // 2, (sl.stop or len(data["wav"])) // 2
            batch = {k: torch.cat([torch.from_numpy(data[k][a:b]),
                                   torch.from_numpy(data[k][h + a:h + b])])
                     for k in ("wav", "target")}
        m = make_train_step(cfg, model, opt, rows=rows, **kw)(batch, gen)
        out.update(loss=m["total_loss"], grad_norm=m["grad_norm"])
    out = {k: np.asarray(v.item()) for k, v in out.items()}
    params = {n: p.detach().numpy().copy() for n, p in model.named_parameters()}
    out.update({f"p.{k}": v for k, v in params.items()})
    out.update({f"s.{n}": b.numpy().copy() for n, b in model.named_buffers()})
    out.update({f"g.{n}": (mu / 0.1).numpy() for n, mu in zip(opt.names, opt.moments[0])})
    return out


def psl_blocks(case, local):
    return [local // 2, local // 2] if case in ("psl", "psl_aug", "tfb_psl_aug") else [local]


if __name__ == "__main__":
    rank, world, port, workdir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    from uit_mobile_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", world, rank, strict=True, device="cpu",
                         timeout=120)
    for case in json.load(open(f"{workdir}/cases.json")):
        data = dict(np.load(f"{workdir}/{case}.npz"))
        B = len(data["wav"])
        sl = multihost.host_local_batch_slice(B)
        relu_in = [] if case in AUG_CASES else None
        res = run(case, data, rows=Rows(psl_blocks(case, B // world), "cpu"), sl=sl,
                  record=relu_in)
        np.savez(f"{workdir}/{case}.rank{rank}.npz", **res)
        if relu_in is not None:
            np.savez(f"{workdir}/{case}.rank{rank}.relu.npz", *relu_in)
    print(f"DONE {rank}", flush=True)
'''

CASES = ["plain", "psl", "psl_aug", "tfb_psl_aug", "sed", "sed_aug", "mae", "mae_gen"]
JAX_CASES = ["plain", "psl", "sed", "mae"]
AUG_CASES = ("psl_aug", "tfb_psl_aug", "sed_aug")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_ranks(argv_of, world, deadline=DEADLINE_S, env=None):
    """Run ``world`` child processes (argv_of(rank)); every child is
    joined within ``deadline`` s of the start, and all are killed on the
    first failure or at the deadline. -> outputs."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(argv_of(r), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env) for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=deadline)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    return outs


def _load_cases(workdir: Path):
    path = workdir / "cases.py"
    path.write_text(CASES_SRC)
    spec = importlib.util.spec_from_file_location("dp_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _flat(tree, prefix):
    from uit_mobile_tpu_torch.ckpt.convert import flatten_tree

    return {f"{prefix}{k}": np.asarray(v) for k, v in
            flatten_tree(jax.tree.map(np.asarray, tree), ".").items()}


def _world_data(case, B):
    """JAX-built weights (flat, 'stu.p.' / 'stu.s.' / 'tea.' keys), the batch,
    MAE's noise; deterministic in (case, B)."""
    r = np.random.default_rng(B)
    key = jax.random.key(1)
    out = {}
    if case.startswith("mae"):
        jcfg = jax_mae.MAEConfig(encoder=jax_models.get_model_config(
            "uit_xxxs", outputdim=537, target_length=160, depth=1), mask_ratio=0.75,
            decoder_depth=1)
        p, s = jax_mae.init(jcfg, key)
        out["wav"] = (r.standard_normal((B, 160 * 160)) * 0.1).astype(np.float32)
        # what JAX's forward draws from MAE_KEY for the global batch
        out["noise"] = np.asarray(jax.random.uniform(MAE_KEY, (B, jcfg.num_patches)))
    else:
        jcfg = _jax_cfg(case)
        p, s = jax_models.build(jcfg, key)
        out["wav"] = (r.standard_normal((B, 16000)) * 0.1).astype(np.float32)
        shape = (B, 6, 10) if case.startswith("sed") else (B, 37)
        out["target"] = (r.uniform(size=shape) > 0.7).astype(np.float32)
        if case in ("psl", "psl_aug", "tfb_psl_aug"):
            tp, ts = _jax_teacher()
            out.update(_flat(tp, "tea.p."), **_flat(ts, "tea.s."))
    out.update(_flat(p, "stu.p."), **_flat(s, "stu.s."))
    return jcfg, p, s, out


def _jax_teacher():
    return jax_models.build(jax_models.get_model_config("MobileNetV2", outputdim=17),
                            jax.random.key(2))


def _jax_cfg(case):
    """The JAX config of the case's student (its weights' shapes)."""
    aug = dict(drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2)
    kw = dict(target_length=102)
    if case in ("plain", "psl"):
        return jax_models.get_model_config("uit_xxxs", outputdim=37, depth=1, **kw)
    if case.startswith("sed"):
        return jax_models.get_model_config("uit_xxxs", outputdim=10, depth=1, pooling="dm",
                                           **kw, **(aug if case == "sed_aug" else {}))
    return jax_models.get_model_config("uit_xxxs", outputdim=37, depth=2, **kw, **aug)


def _jax_dp_step(case, jcfg, p, s, data):
    """JAX's step jitted over the 8-device mesh -> (loss, flat params, flat
    clipped gradients: AdamW's first moment after one update / 0.1)."""
    opt = jax_build_optimizer("AdamW", 1e-3, weight_decay=1e-8)
    mesh = jax_make_mesh()
    repl, shard = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    if case == "mae":
        def step(params, state, opt_state, wav):
            def loss_of(q):
                return jax_mae.forward(jcfg, q, state, wav, MAE_KEY)[0]

            loss, grads = jax.value_and_grad(loss_of)(params)
            updates, opt_state = opt.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), loss

        fn = jax.jit(step, in_shardings=(repl, repl, repl, shard), out_shardings=(repl, repl))
        new_p, loss = fn(p, s, opt.init(p), jnp.asarray(data["wav"]))
        return float(loss), _flat(new_p, "p."), None
    if case == "sed":
        step = jax_framewise_step(jcfg, opt, max_grad_norm=1.0)
    elif case == "psl":  # the flat [all audioset, all kws] batch
        step = jax_make_train_step(jcfg, opt, psl_cfg=jax_models.get_model_config(
            "MobileNetV2", outputdim=17), max_grad_norm=1.0, psl_split=len(data["wav"]) // 2,
            distill_classes=10)
    else:
        step = jax_make_train_step(jcfg, opt)
    batch = {"wav": jnp.asarray(data["wav"]), "target": jnp.asarray(data["target"])}
    fn = jax.jit(step, in_shardings=(repl, repl, repl, shard, repl) + ((repl, repl)
                                                                    if case != "sed" else ()),
                 out_shardings=(repl, repl, repl, repl))
    extra = {"plain": (None, None), "psl": _jax_teacher(), "sed": ()}[case]
    new_p, _, new_o, m = fn(p, s, opt.init(p), batch, jax.random.key(0), *extra)
    return (float(m["total_loss"]), _flat(new_p, "p."),
            _flat(jax.tree.map(lambda mu: mu / 0.1, new_o[0].mu), "g."))


@pytest.fixture(scope="module", params=[1, 2, 4], ids=["1rank", "2ranks", "4ranks"])
def dp_run(request, tmp_path_factory):
    """Every case at one world size: the ranks' results and the single
    process's."""
    world = request.param
    B = {1: 8, 2: 12, 4: 16}[world]
    workdir = tmp_path_factory.mktemp(f"dp{world}")
    cases_mod = _load_cases(workdir)
    jax_side, datas = {}, {}
    for case in CASES:
        jcfg, p, s, datas[case] = _world_data(case, B)
        np.savez(workdir / f"{case}.npz", **datas[case])
        if case in JAX_CASES and world == 4:  # B=16 divides the 8-device mesh
            jax_side[case] = _jax_dp_step(case, jcfg, p, s, datas[case])
    (workdir / "cases.json").write_text(json.dumps(CASES))
    port = _free_port()
    spawn_ranks(lambda r: [sys.executable, str(workdir / "cases.py"), str(r), str(world),
                           str(port), str(workdir)], world)
    ranks = {case: [dict(np.load(workdir / f"{case}.rank{r}.npz")) for r in range(world)]
             for case in CASES}
    single, given, signs = {}, {}, {}
    for case in CASES:
        free = [] if case in AUG_CASES and world > 1 else None
        single[case] = cases_mod.run(case, datas[case], record=free)
        if free is not None:
            rank_inputs = []
            for r in range(world):
                with np.load(workdir / f"{case}.rank{r}.relu.npz") as z:
                    rank_inputs.append([z[f"arr_{i}"] for i in range(len(z.files))])
            dp = _global_signs(rank_inputs, cases_mod.psl_blocks(case, B // world))
            given[case] = cases_mod.run(case, datas[case], impose=list(dp))
            flipped = [np.abs(z[a != (z > 0)]) / np.abs(z).max() for a, z in zip(dp, free)]
            signs[case] = {"inputs": int(sum(z.size for z in free)),
                           "flips": int(sum(f.size for f in flipped)),
                           "flip_rel": max((float(f.max()) for f in flipped if f.size),
                                           default=0.0)}
    return world, ranks, single, jax_side, given, signs


def _global_signs(rank_inputs, blocks):
    """Each rank's recorded ReLU inputs -> the global batch's signs, call by
    call (a call's rows are the rank's rows of the global batch)."""
    from uit_mobile_tpu_torch.parallel.rows import Rows

    world = len(rank_inputs)
    index = [Rows(blocks, "cpu", rank=r, world=world).index.numpy() for r in range(world)]
    out = []
    for calls in zip(*rank_inputs):
        full = np.empty((calls[0].shape[0] * world,) + calls[0].shape[1:], bool)
        for r, local in enumerate(calls):
            full[index[r]] = local > 0
        out.append(full)
    return out


@pytest.mark.parametrize("case", CASES)
def test_dp_step_equals_the_single_process_step(dp_run, case):
    world, ranks, single, _, given, signs = dp_run
    got, want = ranks[case][0], single[case]
    if world == 1:  # a group of one rank: its collectives copy, bit for bit
        assert got.keys() == want.keys()
        assert all(np.array_equal(got[k], want[k]) for k in want), case
        return
    for other in ranks[case][1:]:  # one program: every rank ends alike
        assert all(np.array_equal(got[k], other[k]) for k in got if not k.startswith("g."))
    if case in AUG_CASES:  # free: the loss, and flips only near 0; given them: every gate
        assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
        assert signs[case]["flip_rel"] <= 1e-5, signs[case]
        want = given[case]
    assert float(got["loss"]) == pytest.approx(float(want["loss"]), rel=1e-5)
    if "grad_norm" in want:
        assert float(got["grad_norm"]) == pytest.approx(float(want["grad_norm"]), rel=1e-4)
    for k, v in want.items():
        if k.startswith("g."):
            assert np.abs(got[k] - v).max() <= 1e-5 * max(np.abs(v).max(), 1e-30), k
        elif k.startswith("s."):
            np.testing.assert_allclose(got[k], v, atol=1e-6, rtol=0, err_msg=k)
        elif k.startswith("p."):
            assert (np.abs(got[k] - v) <= _param_bound(want[f"g.{k[2:]}"])).all(), k


def _param_bound(g, lr=1e-3, eps=1e-8):
    """Each parameter's bound after one AdamW step: 5e-5 plus what the
    gradient gate (1e-5 of the tensor's largest) can move Adam's first
    step, lr * g / (|g| + eps), whose slope is lr * eps / (|g| + eps)^2,
    steepest where |g| is least."""
    dg = 1e-5 * max(np.abs(g).max(), 1e-30)
    return 5e-5 + lr * eps * dg / (np.maximum(np.abs(g) - dg, 0.0) + eps) ** 2


@pytest.mark.parametrize("dp_run", [4], indirect=True, ids=["4ranks"])
@pytest.mark.parametrize("case", JAX_CASES)
def test_dp_step_equals_jax_8_device_step(dp_run, case):
    """B=16 divides the 8-device JAX mesh: the 4-rank batch. The JAX test's
    gates, loss 1e-5 and parameters 5e-5; in the PSL step, whose head holds
    gradients near 0, each parameter within 5e-5 plus what the gradient
    gate (1e-5 of each tensor's largest, against JAX's) can move Adam's
    first step (``_param_bound``)."""
    world, ranks, _, jax_side, _, _ = dp_run
    loss, params, grads = jax_side[case]
    got = ranks[case][0]
    assert abs(float(got["loss"]) - loss) < 1e-5
    if case == "psl":
        for k, g in grads.items():
            assert np.abs(got[k] - g).max() <= 1e-5 * max(np.abs(g).max(), 1e-30), k
    for k, v in params.items():
        atol = _param_bound(grads[f"g.{k[2:]}"]) if case == "psl" else 5e-5
        assert (np.abs(got[k] - v) <= atol).all(), (k, np.abs(got[k] - v).max())


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def test_single_process_step_gains_no_op():
    """The single-process recipe-like step (PSL teacher, mixup, every
    augment, dropout, drop-path, clipping; no ``rows``) dispatches 1,174
    aten ops once the frontend's constants are cached: the data-parallel
    layer adds no collective and no launch to the single-process path. (It
    was 1,225 while the optimizer was ``torch.optim``'s with Python
    scalars: its 52 host reads of each parameter's ``step`` went when the
    update came to read its scalars from the device, ops/graphs.py.)"""
    from uit_mobile_tpu_torch import models
    from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

    cfg = models.get_model_config("uit_xxxs", outputdim=37, target_length=102, depth=1,
                                  drop_rate=0.1, drop_path_rate=0.1)
    model = models.build(cfg, torch.Generator().manual_seed(0), device="cpu")
    t_cfg = models.get_model_config("MobileNetV2", outputdim=17)
    teacher = models.build(t_cfg, torch.Generator().manual_seed(1), device="cpu")
    step = make_train_step(
        cfg, model, build_optimizer("AdamW", 1e-3).init(model), mixup_alpha=0.5,
        max_grad_norm=1.0, psl_cfg=t_cfg, psl_model=teacher.eval().requires_grad_(False),
        psl_split=2, distill_classes=10,
        wav_augment=parse_wavtransforms({"Shift": {}, "Gain": {}, "PolarityInversion": {}}),
        spec_augment=parse_spectransforms({"TimeMasking": {}, "FrequencyMasking": {}}),
        frontend_fn=make_frontend_fn(cfg.frontend, precision="exact"),
        psl_frontend_fn=make_frontend_fn(t_cfg.frontend, precision="exact", layout="tfb_to_bft"))
    r = np.random.default_rng(0)
    batch = {"wav": torch.from_numpy((r.standard_normal((4, 16000)) * 0.1).astype(np.float32)),
             "target": torch.from_numpy((r.uniform(size=(4, 37)) > 0.7).astype(np.float32))}
    step(batch, torch.Generator().manual_seed(0))  # caches the frontend's constants
    with _CountOps() as ops:
        m = step(batch, torch.Generator().manual_seed(0))
    assert ops.n == 1174
    assert torch.isfinite(m["total_loss"])


# ------------------------------------------------- in-process data parallelism

@pytest.fixture(scope="module")
def eval_world(tmp_path_factory):
    from test_torch_evaluate import build_world

    return build_world(tmp_path_factory.mktemp("dpworld"))


def _two_cpu_replicas():
    from uit_mobile_tpu_torch.parallel import make_mesh

    return make_mesh(devices=["cpu", "cpu"])


def test_dp_evaluator_equals_jax_dp_evaluator(eval_world, tmp_path):
    """Exact: the plain frontend (the CPU's default), its batch-global clamp
    reduced over the two replicas, against JAX's GSPMD evaluator over 8
    devices (probabilities 1e-5, metrics 1e-6); batches of 3 pad to the
    mesh. Exact on the kernel's route keeps it (its clamp reduced the same
    way), within 1e-5 of the non-DP run. Fast: the kernel's route with the
    per-sample clamp, within JAX's 1e-3 of the non-DP run."""
    from uit_mobile_tpu.evaluate import Evaluator as JaxEvaluator
    from uit_mobile_tpu_torch.evaluate import Evaluator

    def preds(ev, mode, tag):
        path = str(tmp_path / f"{tag}.npz")
        data = eval_world["gsc"] if mode == "gsc" else eval_world["audioset"]
        res = (ev.gsc(eval_data=data, dump_predictions=path) if mode == "gsc"
               else ev.audioset(audioset_eval_data=data, dump_predictions=path))
        return np.load(path)["preds"], res

    for mode in ("gsc", "audioset"):
        port = Evaluator(eval_world["ckpt"], device="cpu", batch_size=3, report_dir=str(tmp_path),
                         data_parallel=_two_cpu_replicas())
        assert port.mesh.size == 2
        got, got_m = preds(port, mode, f"port_{mode}")
        assert port._fwd_fn.uses_kernel is False and port._fwd_fn.top_db_mode == "torch"
        jax_ev = JaxEvaluator(eval_world["ckpt"], use_pallas=False, batch_size=3,
                              report_dir=str(tmp_path), data_parallel=True)
        want, want_m = preds(jax_ev, mode, f"jax_{mode}")
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
        for k, v in want_m.items():
            if isinstance(v, float) and np.isfinite(v):
                assert abs(got_m[k] - v) <= 1e-6, k
    exact = Evaluator(eval_world["ckpt"], device="cpu", batch_size=3, report_dir=str(tmp_path),
                      use_kernel=True, data_parallel=_two_cpu_replicas())
    got, _ = preds(exact, "gsc", "exact_dp")
    assert exact._fwd_fn.uses_kernel and exact._fwd_fn.top_db_mode == "torch"
    plain = Evaluator(eval_world["ckpt"], device="cpu", batch_size=3, report_dir=str(tmp_path),
                      use_kernel=True)
    np.testing.assert_allclose(got, preds(plain, "gsc", "exact")[0], atol=1e-5, rtol=0)
    fast = Evaluator(eval_world["ckpt"], device="cpu", batch_size=3, report_dir=str(tmp_path),
                     use_kernel=True, fast=True, data_parallel=_two_cpu_replicas())
    got, _ = preds(fast, "gsc", "fast_dp")
    assert fast._fwd_fn.uses_kernel and fast._fwd_fn.top_db_mode == "per_sample"
    plain = Evaluator(eval_world["ckpt"], device="cpu", batch_size=3, report_dir=str(tmp_path),
                      use_kernel=True, fast=True)
    np.testing.assert_allclose(got, preds(plain, "gsc", "fast")[0], atol=1e-3, rtol=0)


@pytest.mark.parametrize("top_db_mode", ["per_sample", "torch"])
def test_dp_service_equals_jax_dp_service(eval_world, top_db_mode):
    """TaggingService over two CPU replicas against JAX's over 8 devices on
    the same weights: 1 s to 3 s clips, probabilities 1e-5; buckets round
    to the mesh (JAX: 8, the port: 2)."""
    from uit_mobile_tpu.cli.common import resolve_model as jax_resolve
    from uit_mobile_tpu.serve import ServiceConfig as JaxServiceConfig
    from uit_mobile_tpu.serve import TaggingService as JaxService
    from uit_mobile_tpu_torch.cli.common import resolve_model
    from uit_mobile_tpu_torch.serve import ServiceConfig, TaggingService

    r = np.random.default_rng(4)
    clips = [(r.standard_normal(n) * 0.1).astype(np.float32)
             for n in (16000, 9000, 32000, 16000, 40000)]
    cfg, model = resolve_model(eval_world["ckpt"], device="cpu")
    conf = dict(batch_size=4, max_seconds=3, warmup=False, top_db_mode=top_db_mode)
    with TaggingService(cfg, model, ServiceConfig(**conf, data_parallel=_two_cpu_replicas()),
                        device="cpu") as svc:
        assert [bs % 2 for _, bs in svc._buckets] == [0, 0, 0]
        got = np.stack(svc.infer_many(clips))
    jcfg, params, state = jax_resolve(eval_world["ckpt"])
    jsvc = JaxService(jcfg, params, state, JaxServiceConfig(**conf, use_pallas=False,
                                                           data_parallel=True))
    try:
        want = np.stack(jsvc.infer_many(clips))
    finally:
        jsvc.close()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
