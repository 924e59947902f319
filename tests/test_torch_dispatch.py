"""The port's one-program dispatch on the CPU: the K-step, the Trainer's
``steps_per_dispatch``, the optimizers whose update reads its scalars from
the device, and the bodies that the card captures as CUDA graphs
(ops/graphs.py), against the JAX package and against themselves.

On the CPU ``graphed`` is the function itself, so these tests run the
bodies the card captures, eagerly. Tolerances: the K-step against JAX's
jitted ``make_multi_step`` as tests/test_torch_steps.py holds one step
(losses 1e-5 relative, gradient norms 1e-4 relative, BN state and SGD
parameters 1e-6 absolute); the Trainer against JAX's Trainer: parameters
1e-6 absolute under SGD, the logged epoch loss to its 4 printed decimals;
the optimizers against ``torch.optim``'s foreach rules (and today's
Adafactor) bitwise, against optax 1e-6 relative as
tests/test_torch_steps.py:test_optimizer_rules_match_optax; the K-step
against K single port steps, bitwise."""

import copy

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pandas as pd
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load_checkpoint
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save_checkpoint
from uit_mobile_tpu.train.loop import train_from_config as jax_train_from_config
from uit_mobile_tpu.train.schedule import cosine_with_warmup as jax_cosine
from uit_mobile_tpu.train.steps import build_optimizer as jax_build_optimizer
from uit_mobile_tpu.train.steps import find_ema_params as jax_find_ema
from uit_mobile_tpu.train.steps import make_multi_step as jax_make_multi_step
from uit_mobile_tpu.train.steps import make_train_step as jax_make_train_step
from uit_mobile_tpu.train.steps import wrap_optimizer as jax_wrap_optimizer
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import load_model, module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.ops import graphs, make_forward_fn, make_scanned_forward
from uit_mobile_tpu_torch.train import (build_optimizer, cosine_with_warmup, find_ema_params,
                                        make_multi_step, make_train_step, train_from_config,
                                        wrap_optimizer)
from uit_mobile_tpu_torch.train.loop import Trainer
from uit_mobile_tpu_torch.train.steps import adafactor_decay

torch.set_num_threads(1)
B, C, K = 4, 21, 3


@pytest.fixture(scope="module")
def world():
    kw = dict(outputdim=C, target_length=102, depth=2)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    tj = jax_models.get_model_config("MobileNetV2", outputdim=17)
    tp, ts = jax_models.build(tj, jax.random.key(1))
    r = np.random.default_rng(7)
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"jcfg": jcfg, "params": params, "state": state,
            "cfg": models.get_model_config("uit_xxxs", **kw),
            "p_np": np_tree(params), "s_np": np_tree(state),
            "teacher": (tj, tp, ts, np_tree(tp), np_tree(ts)),
            "wavs": (r.standard_normal((K, B, 16000)) * 0.1).astype(np.float32),
            "tgts": (r.uniform(size=(K, B, C)) > 0.7).astype(np.float32)}


def _model(world):
    return module_from_numpy(world["cfg"], world["p_np"], world["s_np"], device="cpu")


def _teacher(world):
    tj, _, _, tp, ts = world["teacher"]
    cfg = models.get_model_config("MobileNetV2", outputdim=tj.outputdim)
    return cfg, module_from_numpy(cfg, tp, ts, device="cpu").requires_grad_(False)


@pytest.mark.parametrize("psl", [False, True])
def test_multi_step_matches_jax(world, psl):
    """K=3 stacked batches through the port's make_multi_step and JAX's
    jitted one, SGD with momentum under a warmup+cosine schedule, gradient
    clipping (and the PSL teacher on half the rows)."""
    kw = dict(max_grad_norm=1.0, psl_split=B // 2 if psl else None, distill_classes=10)
    sched_args = (0.5, 10, 2)
    batches = {"wav": world["wavs"], "target": world["tgts"]}

    jopt = jax_build_optimizer("SGD", jax_cosine(*sched_args), momentum=0.9)
    tj, tp, ts = world["teacher"][:3] if psl else (None, None, None)
    jmulti = jax.jit(jax_make_multi_step(jax_make_train_step(world["jcfg"], jopt, psl_cfg=tj,
                                                             **kw), psl=psl))
    jargs = (world["params"], world["state"], jopt.init(world["params"]),
             jax.tree.map(jnp.asarray, batches), jax.random.split(jax.random.key(0), K))
    jp, js, _, jm = jmulti(*jargs, tp, ts) if psl else jmulti(*jargs)

    model = _model(world)
    opt = build_optimizer("SGD", cosine_with_warmup(*sched_args), momentum=0.9).init(model)
    psl_cfg, psl_model = _teacher(world) if psl else (None, None)
    multi = make_multi_step(make_train_step(world["cfg"], model, opt, psl_cfg=psl_cfg,
                                            psl_model=psl_model, **kw))
    m = multi({k: torch.from_numpy(v) for k, v in batches.items()}, torch.Generator())

    assert m["total_loss"].shape == (K,) and opt.count == K
    np.testing.assert_allclose(m["total_loss"].numpy(), np.asarray(jm["total_loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]), rtol=1e-4)
    got_p, got_s = (flatten_tree(t, ".") for t in module_to_numpy(model))
    want_p = flatten_tree(jax.tree.map(np.asarray, jp), ".")
    want_s = flatten_tree(jax.tree.map(np.asarray, js), ".")
    for k, v in got_s.items():
        np.testing.assert_allclose(v, want_s[k], atol=1e-6, rtol=0, err_msg=k)
    for k, v in got_p.items():
        np.testing.assert_allclose(v, want_p[k], atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("opt_name, wrap", [("AdamW", {}),
                                            ("AdamW", {"ema_decay": 0.9, "grad_accum": 2}),
                                            ("Adafactor", {"grad_accum": 2})])
def test_multi_step_bitwise_single_steps(world, opt_name, wrap):
    """The K-step (PSL, mixup, every augment, clipping) gives bitwise the
    losses, parameters, BN state, optimizer leaves and generator state of K
    single port steps; with gradient accumulation the K micro-steps
    straddle an applied update."""
    from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms

    augments = dict(
        mixup_alpha=0.3, max_grad_norm=1.0, psl_split=B // 2, distill_classes=10,
        wav_augment=parse_wavtransforms({"Shift": {}, "Gain": {}, "PolarityInversion": {}}),
        spec_augment=parse_spectransforms([{"TimeMasking": {"time_mask_param": 20}},
                                           {"FrequencyMasking": {"freq_mask_param": 8}}]))
    wavs, tgts = torch.from_numpy(world["wavs"]), torch.from_numpy(world["tgts"])
    runs = []
    for multi in (False, True):
        model = _model(world)
        opt = wrap_optimizer(build_optimizer(opt_name, cosine_with_warmup(1e-3, 10, 2)),
                             **wrap).init(model)
        psl_cfg, psl_model = _teacher(world)
        step = make_train_step(world["cfg"], model, opt, psl_cfg=psl_cfg, psl_model=psl_model,
                               **augments)
        g = torch.Generator().manual_seed(5)
        if multi:
            losses = make_multi_step(step)({"wav": wavs, "target": tgts}, g)["total_loss"]
        else:
            losses = torch.stack([step({"wav": wavs[i], "target": tgts[i]}, g)["total_loss"]
                                  for i in range(K)])
        runs.append((losses, copy.deepcopy(model.state_dict()),
                     [t.clone() for t in opt.state_leaves()], g.get_state()))
    (l1, s1, o1, g1), (l2, s2, o2, g2) = runs
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert len(o1) == len(o2) and all(torch.equal(a, b) for a, b in zip(o1, o2))


def test_multi_step_of_any_train_step_is_k_calls(world):
    """A train step that ``make_train_step`` did not build (here one
    wrapped in a function, as the eager framewise, MAE and MoE steps are
    their own) still takes K stacked batches: exactly K sequential calls,
    bitwise, its metrics stacked."""
    wavs, tgts = torch.from_numpy(world["wavs"]), torch.from_numpy(world["tgts"])
    runs = []
    for multi in (False, True):
        model = _model(world)
        opt = build_optimizer("AdamW", 1e-3).init(model)
        inner = make_train_step(world["cfg"], model, opt, mixup_alpha=0.3, max_grad_norm=1.0)

        def step(batch, generator=None):
            return inner(batch, generator)

        g = torch.Generator().manual_seed(5)
        if multi:
            m = make_multi_step(step)({"wav": wavs, "target": tgts}, g)
            assert m["grad_norm"].shape == (K,)
            losses = m["total_loss"]
        else:
            losses = torch.stack([step({"wav": wavs[i], "target": tgts[i]}, g)["total_loss"]
                                  for i in range(K)])
        runs.append((losses, copy.deepcopy(model.state_dict()), g.get_state()))
    (l1, s1, g1), (l2, s2, g2) = runs
    assert torch.equal(l1, l2) and torch.equal(g1, g2)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


# ------------------------------------------------------------ the Trainer


@pytest.fixture()
def synth_env(tmp_path):
    """Two tiny datasets (AudioSet-like labels 0-526 and keywords 527-536),
    as tests/test_torch_train_loop.py builds them."""
    rng = np.random.default_rng(0)

    def make(name, n, label_pool, lengths=(12000, 17000)):
        h5 = tmp_path / f"{name}.h5"
        rows = []
        with h5py.File(h5, "w") as f:
            for i in range(n):
                L = int(rng.integers(*lengths))
                f[f"{name}_{i}.wav"] = (rng.standard_normal(L) * 3000).astype(np.int16)
                lab = ";".join(map(str, rng.choice(label_pool, size=2, replace=False)))
                rows.append((f"{name}_{i}.wav", lab, str(h5)))
        tsv = tmp_path / f"{name}.tsv"
        pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
            tsv, sep="\t", index=False)
        return str(tsv)

    return dict(audioset_train_data=make("astrain", 16, np.arange(0, 527)),
                audioset_eval_data=make("aseval", 8, np.arange(0, 527)),
                kws_train_data=make("kwstrain", 16, np.arange(527, 537)),
                kws_test_data=make("kwseval", 8, np.arange(527, 537)))


def _trainer_config(tmp_path, synth_env, which, **overrides):
    """Both Trainers start from one JAX-initialized checkpoint (their own
    inits draw from different generators)."""
    init = tmp_path / "init.npz"
    if not init.exists():
        jcfg = jax_models.get_model_config("uit_xxxs", outputdim=537, target_length=102,
                                           depth=1)
        jax_save_checkpoint(init, *jax_models.build(jcfg, jax.random.key(0)), jcfg)
    cfg = dict(outputpath=str(tmp_path / which), num_classes=537, model="uit_xxxs",
               pretrained=str(init),
               model_args={"target_length": 102, "depth": 1}, batch_size=8, epochs=1,
               epoch_length=7, steps_per_dispatch=K, warmup_iters=2, chunk_length=1.0,
               optimizer="SGD", optimizer_args={"lr": 0.1, "momentum": 0.9},
               max_grad_norm=1.0, early_stop=10, valid_every=10, num_workers=0, seed=0,
               config_stem="dispatch", **synth_env)
    cfg.update(overrides)
    return cfg


def _epoch_loss(out) -> float:
    [line] = [ln for ln in (out.parent / "train.log").read_text().splitlines()
              if "Epoch 1" in ln and " loss " in ln]
    return float(line.split(" loss ")[1].split()[0])


def test_trainer_steps_per_dispatch_matches_jax(tmp_path, synth_env):
    """steps_per_dispatch: 3 over an epoch of 7 steps (groups 3 + 3, then
    one single step), the port's Trainer and JAX's on the same config and
    data: the final parameters, the logged epoch loss and the step count;
    and the port's run bitwise its own run at steps_per_dispatch 1."""
    out = train_from_config(_trainer_config(tmp_path, synth_env, "port"), device="cpu")
    jout = jax_train_from_config(_trainer_config(tmp_path, synth_env, "jax"))
    assert out.name == jout.name == "final.npz"
    _, model, extra = load_model(out, device="cpu")
    jp, _, _, jextra = jax_load_checkpoint(jout)
    assert extra["step"] == jextra["step"] == 7
    assert "scanned training: 3 steps" in (out.parent / "train.log").read_text()
    assert _epoch_loss(out) == _epoch_loss(jout)
    got = flatten_tree(module_to_numpy(model)[0], ".")
    want = flatten_tree(jax.tree.map(np.asarray, jp), ".")
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-6, rtol=0, err_msg=k)

    single = train_from_config(_trainer_config(tmp_path, synth_env, "single",
                                               steps_per_dispatch=1), device="cpu")
    alone = flatten_tree(module_to_numpy(load_model(single, device="cpu")[1])[0], ".")
    assert got.keys() == alone.keys()
    assert all(np.array_equal(got[k], alone[k]) for k in got)
    assert _epoch_loss(out) == _epoch_loss(single)


def test_stack_group_pads_as_jax():
    """A full-clip group's batches of other lengths stack zero-padded on
    the last axis, as the JAX loop's stack_leaves."""
    group = [{"wav": torch.full((2, n), float(n)), "target": torch.ones(2, 5) * n}
             for n in (3, 5, 4)]
    out = Trainer.stack_group(group)
    assert out["wav"].shape == (3, 2, 5) and out["target"].shape == (3, 2, 5)
    for i, n in enumerate((3, 5, 4)):
        assert torch.equal(out["wav"][i, :, :n], group[i]["wav"])
        assert not out["wav"][i, :, n:].any()
        assert torch.equal(out["target"][i], group[i]["target"])


# -------------------------------------------------------------- optimizers


def _today_adafactor(h, p, g, st, lr):
    """The Adafactor update as the port computed it before its scalars moved
    to the device: decay from the host's int(step), Python float scalars."""
    t = np.float32(int(st["step"]) - h["decay_offset"] + 1)
    decay = float(np.float32(1.0) - t ** np.float32(-h["decay_rate"]))
    grad_sqr = g * g + h["eps"]
    if st["dims"] is not None:
        d1, d0 = st["dims"]
        st["v_row"].copy_(decay * st["v_row"] + (1.0 - decay) * grad_sqr.mean(dim=d0))
        st["v_col"].copy_(decay * st["v_col"] + (1.0 - decay) * grad_sqr.mean(dim=d1))
        reduced_d1 = d1 - 1 if d1 > d0 else d1
        row_factor = (st["v_row"] / st["v_row"].mean(dim=reduced_d1, keepdim=True)) ** -0.5
        u = g * row_factor.unsqueeze(d0) * (st["v_col"] ** -0.5).unsqueeze(d1)
    else:
        st["v"].copy_(decay * st["v"] + (1.0 - decay) * grad_sqr)
        u = g * st["v"] ** -0.5
    if h["clipping_threshold"] is not None:
        u = u / torch.clamp(torch.sqrt((u * u).mean()) / h["clipping_threshold"], min=1.0)
    u = u * lr
    if h["multiply_by_parameter_scale"]:
        rms = torch.sqrt((p * p).mean())
        u = u * torch.where(rms <= 1e-3, torch.full_like(rms, 1e-3), rms)
    if h["momentum"] is not None:
        st["momentum"].copy_(h["momentum"] * st["momentum"] + (1.0 - h["momentum"]) * u)
        u = st["momentum"]
    if h["weight_decay_rate"] is not None:
        u = u + h["weight_decay_rate"] * p
    p.sub_(u)
    st["step"] += 1


SHAPES = {"w": (128, 384), "k": (384, 128), "b": (384,), "p": (16, 16, 4), "s": (5, 3)}
OPT_CASES = [("Adam", {}), ("Adam", {"b1": 0.8, "eps": 1e-6}),
             ("AdamW", {"weight_decay": 0.05}), ("SGD", {"momentum": 0.9}),
             ("SGD", {"momentum": 0.9, "nesterov": True}), ("SGD", {}),
             ("Adafactor", {}), ("Adafactor", {"momentum": 0.9, "weight_decay_rate": 1e-3,
                                               "decay_rate": 0.5})]


@pytest.mark.parametrize("name, kw", OPT_CASES)
def test_device_scalar_optimizers_bitwise_today_and_near_optax(name, kw):
    """Five updates at uit_xs widths under a warmup+cosine schedule, the lr
    and every other per-update scalar read from the device tensor that
    ``plan`` writes: bitwise ``torch.optim``'s foreach rule with Python
    scalars (Adafactor: the port's rule as it read int(step) from the
    host), and within 1e-6 relative of optax."""
    r = np.random.default_rng(3)
    p0 = {k: r.standard_normal(v).astype(np.float32) * (1e-4 if k == "s" else 1.0)
          for k, v in SHAPES.items()}
    grads = [{k: r.standard_normal(v).astype(np.float32) for k, v in SHAPES.items()}
             for _ in range(5)]
    sched = cosine_with_warmup(1e-3, 10, 2)
    model = torch.nn.Module()
    for k, v in p0.items():
        setattr(model, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = build_optimizer(name, sched, **kw).init(model)
    h = opt.spec.hparams
    ref = [torch.nn.Parameter(torch.from_numpy(p0[n].copy())) for n in opt.names]
    if name == "SGD":
        base = torch.optim.SGD(ref, lr=0.0, momentum=h["momentum"], nesterov=h["nesterov"],
                               foreach=True)
        for p in ref if h["momentum"] else ():
            base.state[p]["momentum_buffer"] = torch.zeros_like(p)
    elif name != "Adafactor":
        rule = torch.optim.AdamW if name == "AdamW" else torch.optim.Adam
        base = rule(ref, lr=0.0, betas=(h["b1"], h["b2"]), eps=h["eps"],
                    weight_decay=h["weight_decay"], foreach=True)
        for p in ref:
            base.state[p].update(exp_avg=torch.zeros_like(p), exp_avg_sq=torch.zeros_like(p),
                                 step=torch.tensor(0.0))
    else:
        full = dict(opt.base.defaults)
        states = [{k: v.clone() if torch.is_tensor(v) else v
                   for k, v in opt.base.state[p].items()} | {"step": torch.tensor(0.0)}
                  for p in opt.params]
    jopt = jax_build_optimizer(name, jax_cosine(1e-3, 10, 2), **kw)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)
    for n, g in enumerate(grads):
        assert opt.update([torch.from_numpy(g[k]) for k in opt.names])
        if name == "Adafactor":
            with torch.no_grad():
                for p, st, k in zip(ref, states, opt.names):
                    _today_adafactor(full, p, torch.from_numpy(g[k]), st, sched(n))
        else:
            for grp in base.param_groups:
                grp["lr"] = sched(n)
            for p, k in zip(ref, opt.names):
                p.grad = torch.from_numpy(g[k].copy())
            base.step()
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
    for p, q, k in zip(opt.params, ref, opt.names):
        assert torch.equal(p, q), k
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)


def test_adafactor_decay_is_optax_float32():
    """The host's decay of update n: optax's float32 1 - (n + 1 - offset)
    ** -rate, bitwise."""
    for n in range(50):
        for rate, off in ((0.8, 0), (0.5, 0), (0.8, -3)):
            t = jnp.asarray(n - off + 1, jnp.float32)
            want = np.float32(1.0 - jnp.power(t, -jnp.float32(rate)))
            assert np.float32(adafactor_decay(n, off, rate)) == want, (n, rate)


def test_optimizer_plan_kinds_and_scalars():
    """plan(k): 'apply' on every grad_accum-th micro-step and 'accumulate'
    between, the counters advanced, the k rows of scalars written."""
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.zeros(3))
    opt = wrap_optimizer(build_optimizer("SGD", lambda n: 0.5 + n), grad_accum=2).init(m)
    assert opt.plan(3) == ("accumulate", "apply", "accumulate")
    assert (opt.count, opt.micro) == (1, 1)
    rows = dict(zip(opt._columns, opt.scalars(3).t()))
    assert rows["neg_lr"].tolist() == [0.0, -0.5, 0.0]
    assert rows["acc_keep"].tolist() == [0.0, 0.5, 0.0]
    assert rows["acc_new"].tolist() == [1.0, 0.5, 1.0]
    assert opt.plan(1) == ("apply",) and opt.scalars(1)[0, 0].item() == -1.5


# ------------------------------------------------------- captured bodies

# aten ops that read a device value on the host (a sync, and a value a
# CUDA graph would freeze) or whose output shape depends on the data
HOST_READS = {"_local_scalar_dense", "item", "nonzero", "masked_select", "is_nonzero",
              "equal", "unique", "_unique", "_unique2", "tolist"}


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def _host_reads(fn) -> set:
    with _AtenOps() as rec:
        fn()
    assert rec.ops
    return set(rec.ops) & HOST_READS


def test_captured_bodies_read_nothing_on_the_host(world):
    """The bodies the card captures (a forward and the K-block forward, the
    train step with PSL, mixup and every augment, the K-step, each
    optimizer's device update) call no aten op that reads the device from
    the host."""
    from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms

    model = _model(world).eval()
    wav = torch.from_numpy(world["wavs"][0])
    fwd = make_forward_fn(world["cfg"], model, use_kernel=True, precision="fast")
    assert _host_reads(lambda: fwd.body(wav)) == set()
    scanned = make_scanned_forward(fwd)
    assert _host_reads(lambda: scanned(torch.from_numpy(world["wavs"]))) == set()

    model = _model(world)
    opt = wrap_optimizer(build_optimizer("AdamW", cosine_with_warmup(1e-3, 10, 2)),
                         ema_decay=0.9, grad_accum=2).init(model)
    psl_cfg, psl_model = _teacher(world)
    step = make_train_step(
        world["cfg"], model, opt, psl_cfg=psl_cfg, psl_model=psl_model, psl_split=B // 2,
        distill_classes=10, mixup_alpha=0.3, max_grad_norm=1.0,
        wav_augment=parse_wavtransforms({"Shift": {}, "Gain": {}, "PolarityInversion": {}}),
        spec_augment=parse_spectransforms([{"TimeMasking": {}}, {"FrequencyMasking": {}}]))
    g = torch.Generator().manual_seed(0)
    batch = {"wav": wav, "target": torch.from_numpy(world["tgts"][0])}
    for kind in opt.plan(2):
        assert _host_reads(lambda: step.device_step(batch, g, kind, opt.scalars(2)[0])) == set()
    multi = make_multi_step(step)
    stacked = {"wav": torch.from_numpy(world["wavs"]), "target": torch.from_numpy(world["tgts"])}
    kinds = opt.plan(K)
    assert _host_reads(lambda: multi.body(stacked, g, kinds)) == set()

    for name, kw in OPT_CASES:
        m = torch.nn.Module()
        m.w = torch.nn.Parameter(torch.ones(4, 130))
        o = wrap_optimizer(build_optimizer(name, 1e-3, **kw), ema_decay=0.9,
                           grad_accum=2).init(m)
        for kind in o.plan(2):
            assert _host_reads(lambda: o.device_update([torch.ones(4, 130)], kind,
                                                       o.scalars(2)[0])) == set(), name


def test_graphed_is_the_function_on_the_cpu():
    """On a CPU device ``graphed`` returns the function: the eager path the
    caller asked for; the forwards carry no graphs there, and their eager
    version (the data-parallel shards') is the forward itself."""
    def f(x):
        return x + 1

    assert graphs.graphed(f, "cpu") is f
    assert graphs.calls_to_capture(f) == 1
    fwd = make_forward_fn(models.get_model_config("uit_xxxs", outputdim=C, depth=1),
                          models.build(models.get_model_config("uit_xxxs", outputdim=C,
                                                               depth=1),
                                       torch.Generator().manual_seed(0), "cpu"))
    assert fwd.graphs is None and graphs.calls_to_capture(fwd) == 1
    assert fwd.eager is fwd
