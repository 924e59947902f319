"""The port's train steps (uit_mobile_tpu_torch.train.steps, .schedule)
against the JAX package's on the CPU.

Same weights (carried by ckpt/convert.py), same batch, stochastic parts off
(no mixup, no augments, no dropout), rfft frontend in both. Tolerances:
losses 1e-6; the schedule 1e-9 relative (optax evaluated in float64); one
train step: loss 1e-5 relative, pre-clip gradient norm 1e-4 relative,
updated parameters max |diff| 1e-6 under SGD; under AdamW the gradients
within 1e-5 of each tensor's largest and the port's AdamW fed JAX's
gradients 1e-6 from JAX's parameters over every element (the step's own
update is not compared element by element: Adam's first step is
lr * g / (|g| + eps), +-lr near a zero gradient whatever the sign of a
rounding). The optimizer
rules against optax over several updates with given gradients: 1e-6
relative."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.train.schedule import cosine_with_warmup as jax_cosine
from uit_mobile_tpu.train.steps import build_optimizer as jax_build_optimizer
from uit_mobile_tpu.train.steps import find_ema_params as jax_find_ema
from uit_mobile_tpu.train.steps import make_loss as jax_make_loss
from uit_mobile_tpu.train.steps import make_train_step as jax_make_train_step
from uit_mobile_tpu.train.steps import wrap_optimizer as jax_wrap_optimizer
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.train import (build_optimizer, cosine_with_warmup, find_ema_params,
                                        make_loss, make_multi_step, make_train_step,
                                        wrap_optimizer)

torch.set_num_threads(1)
B, C = 4, 21


# ------------------------------------------------------------------ losses

LOSS_CASES = [
    ("BCELoss", {}), ("BCELoss", {"reduction": "sum"}),
    ("BCELoss", {"weight": np.linspace(0.5, 2.0, C).tolist()}),
    ("CrossEntropyLoss", {}), ("CrossEntropyLoss", {"label_smoothing": 0.1}),
    ("CrossEntropyLoss", {"weight": np.linspace(0.5, 2.0, C).tolist(), "label_smoothing": 0.2}),
    ("CrossEntropyLoss", {"reduction": "sum", "weight": np.linspace(2.0, 0.5, C).tolist()}),
    ("FocalLoss", {}), ("FocalLoss", {"gamma": 1.5, "alpha": 0.25, "reduction": "sum"}),
]


@pytest.mark.parametrize("name, args", LOSS_CASES)
@pytest.mark.parametrize("soft", [False, True])
def test_losses_match_jax(name, args, soft):
    r = np.random.default_rng(0)
    probs = r.uniform(1e-9, 1.0, (B, C)).astype(np.float32)
    probs[0, :3] = [0.0, 1.0, 1e-8]  # clipped ends
    target = (r.uniform(size=(B, C)) if soft else (r.uniform(size=(B, C)) > 0.7)).astype(np.float32)
    want = float(jax_make_loss(name, **args)(jnp.asarray(probs), jnp.asarray(target)))
    got = make_loss(name, **args)(torch.from_numpy(probs), torch.from_numpy(target)).item()
    assert got == pytest.approx(want, rel=1e-6, abs=1e-6)


def test_unknown_loss_and_optimizer_raise():
    with pytest.raises(KeyError, match="unknown loss"):
        make_loss("BCEWithLogitsLoss")
    with pytest.raises(KeyError, match="unknown optimizer"):
        build_optimizer("Lion", 1e-3)
    # Adafactor and Adam8bit are ported; an option optax.adafactor has and
    # the port does not take fails as loudly as an unknown one
    with pytest.raises(TypeError, match="unexpected options"):
        build_optimizer("Adafactor", 1e-3, weight_decay_mask=None)
    with pytest.raises(TypeError, match="unexpected options"):
        build_optimizer("AdamW", 1e-3, weight_decay=1e-2, amsgrad=True)
    with pytest.raises(ValueError, match="decay"):
        wrap_optimizer(build_optimizer("SGD", 0.1), ema_decay=1.0)


# ---------------------------------------------------------------- schedule

@pytest.mark.parametrize("warmup", [0, 100])
def test_cosine_with_warmup_matches_optax(warmup):
    total = 1000
    port = cosine_with_warmup(1e-3, total, warmup)
    with jax.enable_x64(True):
        ref = jax_cosine(1e-3, total, warmup)
        for step in sorted({0, 1, max(warmup - 1, 0), warmup, (warmup + total) // 2,
                            warmup + total, warmup + total + 5}):
            want = float(ref(step))
            assert port(step) == pytest.approx(want, rel=1e-9, abs=1e-15), step
    assert port(0) == (0.0 if warmup else 1e-3)  # update 0 runs at lr 0 under warmup


# -------------------------------------------------------------- optimizers

OPT_CASES = [
    ("SGD", {}), ("SGD", {"momentum": 0.9}), ("SGD", {"momentum": 0.9, "nesterov": True}),
    ("Adam", {}), ("Adam", {"b1": 0.8, "eps": 1e-6}), ("AdamW", {"weight_decay": 0.05}),
    ("Adafactor", {}), ("Adafactor", {"momentum": 0.9, "weight_decay_rate": 1e-3}),
    ("Adafactor", {"multiply_by_parameter_scale": False, "clipping_threshold": None,
                   "decay_rate": 0.5}),
    ("Adam8bit", {}),
]
# Adafactor's leaves at uit_xs widths: factored (the MLP's 128 x 384 and
# 384 x 128 kernels: row/column accumulators over the two largest dims) and
# unfactored (a bias, the 16 x 16 x 128 reshaped patch kernel's small dims, a
# leaf whose RMS is under the 1e-3 parameter-scale floor)
ADAFACTOR_SHAPES = {"w": (128, 384), "k": (384, 128), "b": (384,), "p": (16, 16, 4),
                    "s": (5, 3)}


@pytest.mark.parametrize("name, kw", OPT_CASES)
@pytest.mark.parametrize("ema", [None, 0.9])
def test_optimizer_rules_match_optax(name, kw, ema):
    """Four updates (Adafactor: five, at uit_xs widths) with given gradients
    under a warmup+cosine schedule peaking at the recipe's lr 1e-3. optax computes Adam's bias corrections
    1 - b**t in float32 (1 - 0.999f is 1.3e-5 from 1e-3), the port in
    float64 as torch.optim does: early Adam updates differ by ~6e-6
    relative, 6e-9 at this lr, inside the 1e-6 relative gate on the params."""
    r = np.random.default_rng(1)
    if name in ("Adafactor", "Adam8bit"):  # five updates at uit_xs widths
        p0 = {k: r.standard_normal(v).astype(np.float32) * (1e-4 if k == "s" else 1.0)
              for k, v in ADAFACTOR_SHAPES.items()}
        n_updates = 5
    else:
        p0 = {"w": r.standard_normal((3, 5)).astype(np.float32),
              "b": r.standard_normal(5).astype(np.float32)}
        n_updates = 4
    grads = [{k: r.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(n_updates)]
    jopt = jax_wrap_optimizer(jax_build_optimizer(name, jax_cosine(1e-3, 10, 2), **kw),
                              ema_decay=ema)
    jp = jax.tree.map(jnp.asarray, p0)
    js = jopt.init(jp)

    model = torch.nn.Module()
    for k, v in p0.items():
        setattr(model, k, torch.nn.Parameter(torch.from_numpy(v.copy())))
    opt = wrap_optimizer(build_optimizer(name, cosine_with_warmup(1e-3, 10, 2), **kw),
                         ema_decay=ema).init(model)
    for g in grads:
        u, js = jopt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        assert opt.update([torch.from_numpy(g[n]) for n in opt.names])
    for n in opt.names:
        np.testing.assert_allclose(getattr(model, n).detach().numpy(), np.asarray(jp[n]),
                                   rtol=1e-6, atol=1e-7)
    if ema is not None:
        for n, v in find_ema_params(opt).items():
            np.testing.assert_allclose(v.numpy(), np.asarray(jax_find_ema(js)[n]),
                                       rtol=1e-6, atol=1e-7)
    else:
        assert find_ema_params(opt) is None


def test_adam8bit_warns_and_takes_adafactor():
    import logging

    from uit_mobile_tpu_torch.utils import get_logger

    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = get_logger()
    logger.addHandler(handler)
    try:
        spec = build_optimizer("Adam8bit", 1e-3, momentum=0.9)
    finally:
        logger.removeHandler(handler)
    assert spec.name == "Adafactor" and spec.hparams == {"momentum": 0.9}
    msg = " ".join(r.getMessage() for r in records)
    assert "Adam8bit" in msg and "substituting Adafactor" in msg


def test_adafactor_training_state_round_trip(tmp_path):
    """save_training_state / load_training_state carry Adafactor's factored
    row and column accumulators, its full ones, momentum and count: the
    reloaded optimizer's next update equals the uninterrupted one's."""
    from uit_mobile_tpu_torch.ckpt import load_training_state, save_training_state

    cfg = models.get_model_config("uit_xxxs", outputdim=C, target_length=102, depth=1)

    def fresh():
        model = models.build(cfg, torch.Generator().manual_seed(0), "cpu")
        return model, build_optimizer("Adafactor", 1e-3, momentum=0.9).init(model)

    r = np.random.default_rng(2)
    model, opt = fresh()
    grads = [[torch.from_numpy(r.standard_normal(p.shape).astype(np.float32))
              for p in opt.params] for _ in range(3)]
    for g in grads[:2]:
        opt.update(g)
    factored = opt.base.state[dict(model.named_parameters())["blocks.0.mlp.fc1.kernel"]]
    assert factored["v_row"].shape == (128,) and factored["v_col"].shape == (384,)
    save_training_state(tmp_path / "s.npz", model, opt, cfg, extra={"step": 2})
    model2, opt2 = fresh()
    _, extra = load_training_state(tmp_path / "s.npz", model2, opt2)
    assert extra == {"step": 2} and opt2.count == 2
    for a, b in zip(opt.state_leaves(), opt2.state_leaves()):
        assert torch.equal(a, b)
    opt.update(grads[2])
    opt2.update(grads[2])
    for a, b in zip(model.parameters(), model2.parameters()):
        assert torch.equal(a, b)


# One EMA update in float32 rounds fl(d e) and fl((1-d) p), their sum, and
# holds d and 1-d to float32: to first order 3 roundings (2^-24 relative)
# of |d e| + |(1-d) p|, counted as ops/mel.py:tolerance_db counts them.
EMA_ROUNDINGS = 3


def _ema_over_gate(e0, emas, params, d):
    """Largest |ema_k - e_k| / bound_k over the updates k, elementwise (<= 1
    passes): e_k = d e_{k-1} + (1-d) p_k in float64 from the float32 e_0,
    bound_k = d bound_{k-1} + EMA_ROUNDINGS 2^-24 (|d e_{k-1}| + |(1-d) p_k|),
    each step's roundings plus the earlier ones carried by the decay."""
    e, bound, worst = e0.double(), torch.zeros(e0.shape, dtype=torch.float64), None
    for ema, p in zip(emas, params):
        a, b = d * e, (1.0 - d) * p.double()
        bound = d * bound + EMA_ROUNDINGS * 2.0 ** -24 * (a.abs() + b.abs())
        e = a + b
        diff = (ema.double() - e).abs()
        ratio = torch.where(diff == 0, 0.0, diff / bound)
        worst = ratio if worst is None else torch.maximum(worst, ratio)
    return worst


def _float32_ema(e0, params, d, alpha):
    """The update e <- d e + alpha p in float32, as a faulty EMA would run it."""
    e, out = e0.clone(), []
    for p in params:
        e = d * e + alpha * p
        out.append(e)
    return out


def test_ema_math_and_real_copy():
    """ema <- decay * ema + (1 - decay) * params after each of 3 updates,
    from a real copy of the initial params: held against a float64
    recurrence of the same update within EMA_ROUNDINGS float32 roundings of
    its summands, on a Linear(3, 2) drawn from a seeded generator and on
    512 seeds at once (one row each); a decay off by 1e-4, or the params
    weighted by d where 1 - d belongs, fails the same gate on every seed."""
    def run(module):
        opt = wrap_optimizer(build_optimizer("SGD", 0.1), ema_decay=0.9).init(module)
        e0 = [p.detach().clone() for p in module.parameters()]
        ema = find_ema_params(opt)
        assert all(e.data_ptr() != p.data_ptr() and torch.equal(e, p)
                   for e, p in zip(ema.values(), module.parameters()))
        emas, params = [], []
        for k in range(3):
            opt.update([torch.ones_like(p) * (k + 1) for p in module.parameters()])
            emas.append([e.clone() for e in ema.values()])
            params.append([p.detach().clone() for p in module.parameters()])
        return [(e0[i], [s[i] for s in emas], [s[i] for s in params]) for i in range(len(e0))]

    gen = torch.Generator().manual_seed(0)
    model = torch.nn.Linear(3, 2)
    for p in model.parameters():
        torch.nn.init.uniform_(p, -1.0, 1.0, generator=gen)
    for e0, emas, params in run(model):
        assert _ema_over_gate(e0, emas, params, 0.9).max() <= 1.0

    seeds = torch.nn.Module()
    seeds.p = torch.nn.Parameter(torch.stack([
        torch.empty(8).uniform_(-1.0, 1.0, generator=torch.Generator().manual_seed(s))
        for s in range(512)]))  # a Linear(3, 2)'s 6 weights and 2 biases a seed
    [(e0, emas, params)] = run(seeds)
    assert _ema_over_gate(e0, emas, params, 0.9).max() <= 1.0
    for d, alpha in ((0.9 + 1e-4, 0.1 - 1e-4), (0.9, 0.9)):
        wrong = _float32_ema(e0, params, d, alpha)
        assert (_ema_over_gate(e0, wrong, params, 0.9).amax(1) > 1.0).all(), (d, alpha)


def test_grad_accum_equals_one_k_fold_batch():
    """K micro-gradients of a mean loss == one update on the K-fold batch
    (SGD), the EMA and the schedule advancing once per applied update; and
    the accumulator against optax.MultiSteps under AdamW."""
    xs = [torch.tensor([1.0, 3.0]), torch.tensor([2.0, -1.0])]

    def grad_of(p, x):
        return torch.autograd.grad((p * x).mean(), p)[0]

    acc_model, one_model = (torch.nn.Module() for _ in range(2))
    for m in (acc_model, one_model):
        m.p = torch.nn.Parameter(torch.tensor(5.0))
    seen_lr = []
    acc = wrap_optimizer(build_optimizer("SGD", lambda n: seen_lr.append(n) or 0.5),
                         ema_decay=0.8, grad_accum=2).init(acc_model)
    applied = [acc.update([grad_of(acc_model.p, x)]) for x in xs]
    assert applied == [False, True] and seen_lr == [0] and acc.count == 1
    one = wrap_optimizer(build_optimizer("SGD", 0.5), ema_decay=0.8).init(one_model)
    one.update([grad_of(one_model.p, torch.cat(xs))])
    torch.testing.assert_close(acc_model.p, one_model.p, rtol=1e-6, atol=0)
    torch.testing.assert_close(find_ema_params(acc)["p"], find_ema_params(one)["p"],
                               rtol=1e-6, atol=0)

    r = np.random.default_rng(2)
    p0 = r.standard_normal(6).astype(np.float32)
    jopt = jax_wrap_optimizer(jax_build_optimizer("AdamW", 1e-2), ema_decay=0.5, grad_accum=3)
    jp, js = jnp.asarray(p0), None
    js = jopt.init(jp)
    m = torch.nn.Module()
    m.w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = wrap_optimizer(build_optimizer("AdamW", 1e-2), ema_decay=0.5, grad_accum=3).init(m)
    for _ in range(7):
        g = r.standard_normal(6).astype(np.float32)
        u, js = jopt.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, u)
        opt.update([torch.from_numpy(g)])
    np.testing.assert_allclose(m.w.detach().numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(find_ema_params(opt)["w"].numpy(), np.asarray(jax_find_ema(js)),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------- train steps

@pytest.fixture(scope="module")
def world():
    kw = dict(outputdim=C, target_length=102, depth=2)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    cfg = models.get_model_config("uit_xxxs", **kw)
    tj = jax_models.get_model_config("MobileNetV2", outputdim=17)
    tp, ts = jax_models.build(tj, jax.random.key(1))
    soft_j = jax_models.get_model_config("MobileNetV2", outputdim=C)
    sp, ss = jax_models.build(soft_j, jax.random.key(2))
    r = np.random.default_rng(0)
    batch = {"wav": (r.standard_normal((B, 16000)) * 0.1).astype(np.float32),
             "target": (r.uniform(size=(B, C)) > 0.7).astype(np.float32)}
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"jcfg": jcfg, "params": params, "state": state, "cfg": cfg,
            "p_np": np_tree(params), "s_np": np_tree(state),
            "teachers": {"psl": (tj, tp, ts, np_tree(tp), np_tree(ts)),
                         "soft": (soft_j, sp, ss, np_tree(sp), np_tree(ss))},
            "batch": batch}


def _port_teacher(world, mode):
    tj, _, _, tp, ts = world["teachers"][mode]
    cfg = models.get_model_config("MobileNetV2", outputdim=tj.outputdim)
    return cfg, module_from_numpy(cfg, tp, ts, device="cpu").requires_grad_(False)


def _batches(world, form):
    b = world["batch"]
    if form != "dict":
        return b
    h = B // 2
    return {"audioset": {"wav": b["wav"][:h], "target": b["target"][:h]},
            "kws": {"wav": b["wav"][h:], "target": b["target"][h:]}}


def _torch_tree(tree):
    return {k: _torch_tree(v) if isinstance(v, dict) else torch.from_numpy(v)
            for k, v in tree.items()}


STEP_CASES = [("none", "flat", "SGD"), ("none", "flat", "AdamW"), ("psl", "flat", "AdamW"),
              ("psl", "dict", "AdamW"), ("soft", "flat", "AdamW"), ("psl", "flat", "SGD")]


@pytest.mark.parametrize("psl, form, opt_name", STEP_CASES)
def test_one_train_step_matches_jax(world, psl, form, opt_name):
    kw = {"weight_decay": 1e-2} if opt_name == "AdamW" else {"momentum": 0.9}
    lr = 1e-3 if opt_name == "AdamW" else 0.5
    step_kw = dict(max_grad_norm=1.0, psl_split=B // 2 if psl != "none" else None,
                   distill_mode="soft" if psl == "soft" else "psl", distill_alpha=0.7,
                   distill_classes=10)
    batch = _batches(world, form)

    jopt = jax_build_optimizer(opt_name, lr, **kw)
    teacher_j = world["teachers"][psl][:3] if psl != "none" else (None, None, None)
    jstep = jax_make_train_step(world["jcfg"], jopt, psl_cfg=teacher_j[0], **step_kw)
    jp, js, jo, jm = jstep(world["params"], world["state"], jopt.init(world["params"]),
                          jax.tree.map(jnp.asarray, batch), jax.random.key(0),
                          teacher_j[1], teacher_j[2])

    model = module_from_numpy(world["cfg"], world["p_np"], world["s_np"], device="cpu")
    opt = build_optimizer(opt_name, lr, **kw).init(model)
    psl_cfg, psl_model = _port_teacher(world, psl) if psl != "none" else (None, None)
    step = make_train_step(world["cfg"], model, opt, psl_cfg=psl_cfg, psl_model=psl_model,
                           **step_kw)
    m = step(_torch_tree(batch), torch.Generator().manual_seed(0))

    assert m["total_loss"].item() == pytest.approx(float(jm["total_loss"]), rel=1e-5)
    assert m["grad_norm"].item() == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
    got_p, got_s = module_to_numpy(model)
    want_p = flatten_tree(jax.tree.map(np.asarray, jp), ".")
    want_s = flatten_tree(jax.tree.map(np.asarray, js), ".")
    for k, v in flatten_tree(got_s, ".").items():  # init_bn moved, as in JAX
        np.testing.assert_allclose(v, want_s[k], atol=1e-6, rtol=0)
    got_p = flatten_tree(got_p, ".")
    if opt_name == "SGD":
        for k, v in got_p.items():
            np.testing.assert_allclose(v, want_p[k], atol=1e-6, rtol=0, err_msg=k)
        return
    # AdamW: the first moment holds (1 - b1) * the clipped gradient after
    # one update, in both packages; each gradient within 1e-5 of its
    # tensor's largest
    jgrads = flatten_tree(jax.tree.map(lambda mu: np.asarray(mu) / 0.1, jo[0].mu), ".")
    for n, mu in zip(opt.names, opt.moments[0]):
        want = jgrads[n]
        assert np.abs((mu / 0.1).numpy() - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30), n
    # the port's optimizer fed JAX's gradients lands on JAX's parameters
    # over every element; the step's own update is not compared element by
    # element: Adam's first step is lr * g / (|g| + eps), so where |g| is
    # ~1e-8 a rounding of g moves the parameter by up to lr
    fresh = module_from_numpy(world["cfg"], world["p_np"], world["s_np"], device="cpu")
    fresh_opt = build_optimizer(opt_name, lr, **kw).init(fresh)
    fresh_opt.update([torch.from_numpy(jgrads[n]) for n in fresh_opt.names])
    for k, v in flatten_tree(module_to_numpy(fresh)[0], ".").items():
        np.testing.assert_allclose(v, want_p[k], atol=1e-6, rtol=0, err_msg=k)


def test_psl_overwrites_only_audioset_rows_and_teacher_stays(world):
    """PSL targets: the teacher's probs replace the first distill_classes
    columns of the AudioSet rows only; the teacher's buffers never move."""
    cfg = world["cfg"]
    model = module_from_numpy(cfg, world["p_np"], world["s_np"], device="cpu")
    opt = build_optimizer("SGD", 0.0).init(model)
    psl_cfg, psl_model = _port_teacher(world, "psl")
    before = {k: v.clone() for k, v in psl_model.state_dict().items()}
    seen = {}

    def loss(probs, targets):
        seen["t"] = targets
        return probs.mean()

    from uit_mobile_tpu_torch.train import steps as steps_mod

    steps_mod.LOSS_FACTORIES["_probe"] = lambda: loss
    try:
        step = make_train_step(cfg, model, opt, loss_name="_probe", psl_cfg=psl_cfg,
                               psl_model=psl_model, psl_split=2, distill_classes=10)
        step(_torch_tree(world["batch"]))
    finally:
        del steps_mod.LOSS_FACTORIES["_probe"]
    t, orig = seen["t"], torch.from_numpy(world["batch"]["target"])
    teacher = models.apply(psl_cfg, psl_model, torch.from_numpy(world["batch"]["wav"][:2]))
    torch.testing.assert_close(t[:2, :10], teacher[:, :10], rtol=0, atol=0)
    assert torch.equal(t[:2, 10:], orig[:2, 10:]) and torch.equal(t[2:], orig[2:])
    assert all(torch.equal(v, before[k]) for k, v in psl_model.state_dict().items())


def test_multi_step_equals_sequential_steps(world):
    cfg = world["cfg"]
    r = np.random.default_rng(3)
    K = 3
    wavs = torch.from_numpy((r.standard_normal((K, B, 16000)) * 0.1).astype(np.float32))
    tgts = torch.from_numpy((r.uniform(size=(K, B, C)) > 0.7).astype(np.float32))
    runs = []
    for multi in (False, True):
        model = module_from_numpy(cfg, world["p_np"], world["s_np"], device="cpu")
        opt = build_optimizer("AdamW", cosine_with_warmup(1e-3, 10, 2)).init(model)
        step = make_train_step(cfg, model, opt, max_grad_norm=1.0, mixup_alpha=0.3)
        g = torch.Generator().manual_seed(5)
        if multi:
            losses = make_multi_step(step)({"wav": wavs, "target": tgts}, g)["total_loss"]
        else:
            losses = torch.stack([step({"wav": wavs[i], "target": tgts[i]}, g)["total_loss"]
                                  for i in range(K)])
        runs.append((losses, copy.deepcopy(model.state_dict()), opt.count))
    (l1, s1, c1), (l2, s2, c2) = runs
    assert torch.equal(l1, l2) and c1 == c2 == K
    assert all(torch.equal(s1[k], s2[k]) for k in s1)


@pytest.mark.parametrize("psl", [False, True])
def test_int16_step_bitwise_f32(world, psl):
    """Raw int16 PCM through a step (plain, and flat PSL with the teacher)
    gives bitwise the loss, gradient norm and parameters of f32/32768."""
    cfg = world["cfg"]
    pcm = np.clip(np.rint(world["batch"]["wav"] * 32768), -32768, 32767).astype(np.int16)
    out = []
    for wav in (pcm, pcm.astype(np.float32) / 32768.0):
        model = module_from_numpy(cfg, world["p_np"], world["s_np"], device="cpu")
        opt = build_optimizer("AdamW", 1e-3).init(model)
        teacher = _port_teacher(world, "psl") if psl else (None, None)
        step = make_train_step(cfg, model, opt, psl_cfg=teacher[0], psl_model=teacher[1],
                               psl_split=2 if psl else None, distill_classes=10)
        m = step({"wav": torch.from_numpy(wav), "target": torch.from_numpy(world["batch"]["target"])})
        out.append((m, model.state_dict()))
    (m1, s1), (m2, s2) = out
    assert torch.equal(m1["total_loss"], m2["total_loss"])
    assert torch.equal(m1["grad_norm"], m2["grad_norm"])
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
