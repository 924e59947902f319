"""The dispatch of the port's other jitted programs on the CPU: the SED,
MAE and MoE steps split into a host plan and a device side (the CUDA graph
on the card), their K-steps, the SED and weak-Trainer validation forwards
on one in-place EMA module, the PSL teacher's scoring and the artifact's
module, against the eager paths and against the JAX package.

On the CPU ``graphed`` is the function itself, so these tests run the
bodies the card captures, eagerly. Tolerances: the split steps and their
K-steps against the unsplit path and against K single steps, bitwise; the
K-steps against JAX's jitted ``make_multi_step`` under SGD at the parity
tolerances of each step's own test (tests/test_torch_framewise_train.py,
test_torch_pretrain.py, test_torch_moe.py): losses 1e-5 relative, gradient
norms 1e-4 relative, parameters and BN state 1e-6 absolute."""

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
from uit_mobile_tpu.parallel import make_moe_train_step as jax_make_moe_train_step
from uit_mobile_tpu.train import pretrain as jax_mae
from uit_mobile_tpu.train.steps import make_framewise_train_step as jax_framewise_step
from uit_mobile_tpu.train.steps import make_multi_step as jax_make_multi_step
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree, load_numpy
from uit_mobile_tpu_torch.models import moe
from uit_mobile_tpu_torch.models import uit as uit_model
from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
from uit_mobile_tpu_torch.parallel import make_moe_train_step
from uit_mobile_tpu_torch.train import (build_optimizer, make_framewise_train_step,
                                        make_multi_step, wrap_optimizer)
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train import steps as steps_mod
from uit_mobile_tpu_torch.train.steps import make_loss, update_from_loss

torch.set_num_threads(1)
SR, K, B = 16000, 4, 2
KINDS = ("sed", "mae", "moe")


def _sed_cfgs():
    kw = dict(outputdim=10, target_length=102, depth=1, pooling="dm")
    return jax_models.get_model_config("uit_xxxs", **kw), models.get_model_config("uit_xxxs", **kw)


def _mae_cfgs():
    kw = dict(outputdim=21, target_length=160, depth=1)
    enc_j, enc = (m.get_model_config("uit_xxxs", **kw) for m in (jax_models, models))
    return (jax_mae.MAEConfig(encoder=enc_j, mask_ratio=0.75, decoder_depth=1),
            mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=1))


def _moe_cfgs():
    kw = dict(outputdim=13, target_length=102, depth=1)
    return (jax_models.get_model_config("uit_xs_moe", **kw),
            models.get_model_config("uit_xs_moe", **kw))


@pytest.fixture(scope="module")
def world():
    """Per kind: the JAX cfg, the numpy weights (the port's init, which the
    JAX trees take as they are), the port's cfg and K batches."""
    r = np.random.default_rng(11)
    out = {}
    for kind, (jcfg, cfg), init in (
            ("sed", _sed_cfgs(), models.build), ("mae", _mae_cfgs(), mae.init),
            ("moe", _moe_cfgs(), models.build)):
        model = init(cfg, torch.Generator().manual_seed(len(out)), *(
            ("cpu",) if init is models.build else ()))
        out[kind] = (jcfg, *module_to_numpy(model), cfg)
    out["sed"] += ({"wav": (r.standard_normal((K, B, SR)) * 0.1).astype(np.float32),
                    "target": (r.uniform(size=(K, B, 6, 10)) > 0.7).astype(np.float32)},)
    out["mae"] += ({"wav": (r.standard_normal((K, B, 160 * 160)) * 0.1).astype(np.float32)},)
    out["moe"] += ({"wav": (r.standard_normal((K, B, SR)) * 0.1).astype(np.float32),
                    "target": (r.uniform(size=(K, B, 13)) > 0.8).astype(np.float32)},)
    return out


def _model(world, kind):
    _, p_np, s_np, cfg, _ = world[kind]
    if kind == "mae":
        return load_numpy(mae.MAE(cfg), p_np, s_np)
    return module_from_numpy(cfg, p_np, s_np, device="cpu")


SED_AUG = dict(max_grad_norm=1.0,
               wav_augment=parse_wavtransforms({"Gain": {}, "PolarityInversion": {}}),
               spec_augment=parse_spectransforms([{"TimeMasking": {"time_mask_param": 20}}]))


def _step(kind, cfg, model, opt):
    """The port's step of ``kind``, called as ``call(batch, generator)``."""
    if kind == "sed":
        step = make_framewise_train_step(cfg, model, opt, **SED_AUG)
        return step, step
    if kind == "mae":
        step = mae.make_mae_step(cfg, model, opt)
        return step, lambda b, g: step(b["wav"], g, noise=b.get("noise"))
    step = make_moe_train_step(cfg, model, opt)
    return step, lambda b, g: step(b["wav"], b["target"], g)


def _unsplit(kind, cfg, model, opt):
    """The steps as they ran before their split: forward, loss and
    ``update_from_loss`` with the host plan inside (plan=None)."""
    bce = make_loss("BCELoss")

    def call(b, g):
        if kind == "sed":
            wav = steps_mod._step_wav(b["wav"], SED_AUG["wav_augment"])
            probs, new_state = uit_model.forward_train_framewise(
                cfg, model, wav, generator=g, wav_augment=SED_AUG["wav_augment"],
                spec_augment=SED_AUG["spec_augment"])
            loss = bce(probs, b["target"])
            update_from_loss(model, opt, loss, new_state, 1.0)
        elif kind == "mae":
            loss, new_state, _ = mae.forward(cfg, model, b["wav"], generator=g)
            update_from_loss(model, opt, loss, new_state)
        else:
            probs, aux, new_state = moe.forward_with_aux(cfg, model, b["wav"], train=True,
                                                         generator=g)
            loss = bce(probs, b["target"]) + cfg.router_aux_weight * aux
            update_from_loss(model, opt, loss, new_state)
        return {"total_loss": loss.detach()}

    return call


def _state(model, opt, g):
    return ([v.clone() for v in model.state_dict().values()]
            + [t.clone() for t in opt.state_leaves()] + [g.get_state()])


def _opt(model):
    spec = build_optimizer("AdamW", lambda n: 1e-3 * (n + 1))
    return wrap_optimizer(spec, ema_decay=0.9, grad_accum=2).init(model)


@pytest.mark.parametrize("kind", KINDS)
def test_split_step_and_k_step_equal_the_unsplit_path(world, kind):
    """Four micro-steps (AdamW, an EMA, grad_accum 2: two applied updates)
    through the split step, its K=4 step and the unsplit path, from one
    start and one generator state: bitwise the same losses, parameters, BN
    state, optimizer leaves and generator state."""
    batches = {k: torch.from_numpy(v) for k, v in world[kind][4].items()}
    runs = {}
    for how in ("unsplit", "split", "k_step"):
        model = _model(world, kind)
        opt = _opt(model)
        step, call = _step(kind, world[kind][3], model, opt)
        g = torch.Generator().manual_seed(5)
        if how == "k_step":
            multi = make_multi_step(step)
            assert multi.body is not None  # the device side, not K sequential calls
            losses = multi(batches, g)["total_loss"]
        else:
            call = _unsplit(kind, world[kind][3], model, opt) if how == "unsplit" else call
            out = [call({k: v[i] for k, v in batches.items()}, g) for i in range(K)]
            losses = torch.stack([m if torch.is_tensor(m) else m["total_loss"] for m in out])
        assert opt.count == 2 and opt.micro == 0
        runs[how] = [losses] + _state(model, opt, g)
    for how in ("split", "k_step"):
        assert len(runs[how]) == len(runs["unsplit"])
        assert all(torch.equal(a, b) for a, b in zip(runs[how], runs["unsplit"])), how


def _jax_steps(kind, jcfg, opt):
    """JAX's step of ``kind`` as make_multi_step takes it (params, state,
    opt_state, batch, rng) -> (params, state, opt_state, metrics)."""
    if kind == "sed":
        return jax_framewise_step(jcfg, opt, max_grad_norm=1.0)
    if kind == "moe":
        step = jax_make_moe_train_step(jcfg, opt)
        return lambda p, s, o, b, k: step(p, s, o, b["wav"], b["target"], k)

    def step(p, s, o, b, k):  # uit_mobile_tpu/train/pretrain.py's step
        def loss_of(q):
            loss, new_state, _ = jax_mae.forward(jcfg, q, s, b["wav"], k)
            return loss, new_state

        (loss, new_state), grads = jax.value_and_grad(loss_of, has_aux=True)(p)
        updates, o = opt.update(grads, o, p)
        return optax.apply_updates(p, updates), new_state, o, {"total_loss": loss}

    return step


@pytest.mark.parametrize("kind", KINDS)
def test_k_step_matches_jax(world, kind):
    """K=3 stacked batches through the port's make_multi_step and JAX's
    jitted one under SGD with momentum (the SED step clipped); MAE's masks
    are JAX's draws, passed as ``noise``."""
    jcfg, params, state, cfg, batches = world[kind]
    k = 3
    batches = {n: v[:k] for n, v in batches.items()}
    lr = 0.05
    jopt = optax.sgd(lr, momentum=0.9)
    keys = jax.random.split(jax.random.key(3), k)
    jmulti = jax.jit(jax_make_multi_step(_jax_steps(kind, jcfg, jopt)))
    params, state = (jax.tree.map(jnp.asarray, t) for t in (params, state))
    jp, js, _, jm = jmulti(params, state, jopt.init(params),
                           jax.tree.map(jnp.asarray, batches), keys)
    port = {n: torch.from_numpy(v) for n, v in batches.items()}
    if kind == "mae":
        port["noise"] = torch.from_numpy(np.stack(
            [np.asarray(jax.random.uniform(key, (B, jcfg.num_patches))) for key in keys]))
    model = _model(world, kind)
    step, _ = _step(kind, cfg, model, build_optimizer("SGD", lr, momentum=0.9).init(model))
    if kind == "sed":  # the parity step runs without the augments' draws
        step = make_framewise_train_step(cfg, model, step.optimizer, max_grad_norm=1.0)
    m = make_multi_step(step)(port, torch.Generator())
    np.testing.assert_allclose(m["total_loss"].numpy(), np.asarray(jm["total_loss"]), rtol=1e-5)
    if "grad_norm" in jm:
        np.testing.assert_allclose(m["grad_norm"].numpy(), np.asarray(jm["grad_norm"]),
                                   rtol=1e-4)
    got_p, got_s = (flatten_tree(t, ".") for t in module_to_numpy(model))
    for got, want in ((got_p, jp), (got_s, js)):
        want = flatten_tree(jax.tree.map(np.asarray, want), ".")
        for n, v in got.items():
            np.testing.assert_allclose(v, want[n], atol=1e-6, rtol=0, err_msg=n)


@pytest.mark.parametrize("kind", KINDS)
def test_steps_take_the_replay_branch_on_the_card(world, kind, monkeypatch):
    """With the card's branch forced on the CPU (``_graphable`` true,
    ``graphed`` recording), each step and its K-step hand ``graphed`` their
    device side, whose body calls no host read of a device value
    (``_local_scalar_dense``: a capture would fail on it)."""
    from uit_mobile_tpu_torch.ops import graphs

    wrapped = []

    def fake_graphed(fn, device, agree=None):
        wrapped.append(lambda *args: fn(*args))
        return wrapped[-1]

    monkeypatch.setattr(steps_mod, "_graphable", lambda opt, rows: True)
    monkeypatch.setattr(graphs, "graphed", fake_graphed)
    model = _model(world, kind)
    step, call = _step(kind, world[kind][3], model, _opt(model))
    multi = make_multi_step(step)
    assert step.graphs is wrapped[0] and multi.graphs is wrapped[1]
    assert step.device_step is step.batch_step.device_step and step.rows is None
    batches = {k: torch.from_numpy(v[:2]) for k, v in world[kind][4].items()}

    class HostReads(TorchDispatchMode):
        seen = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                HostReads.seen += 1
            return func(*args, **(kwargs or {}))

    g = torch.Generator().manual_seed(0)
    with HostReads():
        call({k: v[0] for k, v in batches.items()}, g)
        m = multi(batches, g)
    assert HostReads.seen == 0
    assert m["total_loss"].shape == (2,)


# ------------------------------------------------------ validation forwards


def test_sed_validation_reuses_one_module_holding_the_ema(world):
    """The SED validator keeps one module across validations; at each its
    parameters are the EMA and its buffers the model's, and its scores and
    probabilities equal the eager path on a fresh copy with the EMA."""
    from uit_mobile_tpu_torch.train.sed import make_validator

    cfg = world["sed"][3]
    model = _model(world, "sed")
    opt = _opt(model)
    step = make_framewise_train_step(cfg, model, opt, **SED_AUG)
    fe = make_frontend_fn(cfg.frontend)
    validate = make_validator(cfg, model, opt, fe)
    r = np.random.default_rng(1)
    loader = [{"wav": (r.standard_normal((3, SR)) * 0.1).astype(np.float32),
               "target": (r.uniform(size=(3, 6, 10)) > 0.5).astype(np.float32)}
              for _ in range(2)]
    g = torch.Generator().manual_seed(2)
    module = validate.model.module
    assert module is not model
    for epoch in range(2):
        for i in range(2):
            step({k: torch.from_numpy(v[i]) for k, v in world["sed"][4].items()}, g)
        scores = validate(loader)
        assert validate.model.module is module
        ema = dict(zip(opt.names, opt.ema))
        assert all(torch.equal(p, ema[n]) for n, p in module.named_parameters())
        assert all(torch.equal(a, b) for a, b in zip(module.buffers(), model.buffers()))
        eager = copy.deepcopy(model)
        with torch.no_grad():
            for n, p in eager.named_parameters():
                p.copy_(ema[n])
        for batch in loader:
            got = validate.forward(batch["wav"])[0]
            want = models.apply_framewise(cfg, eager, torch.from_numpy(batch["wav"]),
                                          frontend_fn=fe)[0]
            assert torch.equal(got, want)
        assert set(scores) >= {"Segment_Micro_F1", "Segment_Macro_F1"}


@pytest.fixture()
def trainer_world(tmp_path):
    """A tiny weak world (AudioSet-like labels 0-526, keywords 527-536) in
    h5 + tsv, as tests/test_torch_train_loop.py builds it."""
    rng = np.random.default_rng(0)

    def make(name, n, pool):
        h5, rows = tmp_path / f"{name}.h5", []
        with h5py.File(h5, "w") as f:
            for i in range(n):
                f[f"{name}_{i}.wav"] = (rng.standard_normal(int(rng.integers(12000, 20000)))
                                        * 3000).astype(np.int16)
                rows.append((f"{name}_{i}.wav", ";".join(map(str, rng.choice(pool, 2, False))),
                             str(h5)))
        tsv = tmp_path / f"{name}.tsv"
        pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
            tsv, sep="\t", index=False)
        return str(tsv)

    as_tsv, kws_tsv = make("as", 8, np.arange(527)), make("kws", 8, np.arange(527, 537))
    return {"audioset_train_data": as_tsv, "audioset_eval_data": as_tsv,
            "kws_train_data": kws_tsv, "kws_test_data": kws_tsv}


def test_trainer_validation_reuses_one_module_holding_the_ema(trainer_world, tmp_path,
                                                              monkeypatch):
    """The weak Trainer with an EMA validates three times through one module
    and one eval forward, the module holding the EMA and the model's
    buffers; each validation's predictions equal the eager eval step on a
    fresh copy with the EMA (``with_ema`` as it was)."""
    from uit_mobile_tpu_torch.train import loop

    seen = []
    real = loop.Trainer._validate

    def spy(self, forward, epoch, metric="mAP"):
        if epoch != "avg":
            ema = dict(zip(self.optimizer.names, self.optimizer.ema))
            module = self.eval_model.module
            eager = copy.deepcopy(self.model).eval()
            with torch.no_grad():
                for n, p in eager.named_parameters():
                    p.copy_(ema[n])
            same = all(torch.equal(forward(torch.from_numpy(w)),
                                   self.eval_step(eager, torch.from_numpy(w)))
                       for w, _ in self.validation_batches())
            seen.append((forward is self.eval_fwd, id(module), same,
                         all(torch.equal(p, ema[n]) for n, p in module.named_parameters()),
                         all(torch.equal(a, b)
                             for a, b in zip(module.buffers(), self.model.buffers()))))
        return real(self, forward, epoch, metric)

    monkeypatch.setattr(loop.Trainer, "_validate", spy)
    config = dict(trainer_world, model="uit_xxxs", num_classes=537, batch_size=4, epochs=3,
                  epoch_length=1, model_args={"target_length": 102, "depth": 1},
                  ema_decay=0.9, chunk_length=1.0, num_workers=1, n_saved=1,
                  optimizer="AdamW", optimizer_args={"lr": 1e-3}, warmup_iters=1,
                  outputpath=str(tmp_path / "out"), seed=3)
    loop.train_from_config(config, device="cpu")
    assert len(seen) == 3 and len({s[1] for s in seen}) == 1
    assert all(s[0] and s[2] and s[3] and s[4] for s in seen), seen


# ------------------------------------------------------ teacher, artifact


def test_teacher_cache_equals_the_eager_build():
    """make_teacher_fn's cache (two batches, the last zero-padded to the
    full one) is bitwise the one its eager forward and the eager teacher as
    it was (models.apply through the fused frontend) build."""
    from uit_mobile_tpu_torch.cli.psl_cache import make_teacher_fn
    from uit_mobile_tpu_torch.data.psl_cache import score_psl_cache

    cfg = models.get_model_config("MobileNetV2", outputdim=7)
    model = models.build(cfg, torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(5)
    clips = [(f"c{i}.wav", rng.integers(-9000, 9000, n, dtype=np.int16))
             for i, n in enumerate((SR, 25000, 3 * SR))]
    fe = make_frontend_fn(cfg.frontend)

    def before(batch):
        wav = torch.from_numpy(np.ascontiguousarray(batch))
        return models.apply(cfg, model, wav, frontend_fn=fe).float().numpy()

    fn = make_teacher_fn(cfg, model)
    caches = [score_psl_cache(clips, f, batch_size=16, teacher_name="t")
              for f in (fn, fn.eager, before)]
    assert 16 < sum(caches[0][k].shape[0] for k, _ in clips) < 32  # a padded last batch
    for c in caches[1:]:
        assert all(caches[0][k].tobytes() == c[k].tobytes() for k, _ in clips)


def test_artifact_call_is_the_module_and_reads_no_device_value(tmp_path):
    """load_artifact's fn equals the exported module's call bitwise (a
    kernel artifact at a fixed batch, its mel the custom op), and the module
    reads no device value on the host: its guards are shape checks."""
    from uit_mobile_tpu_torch.ckpt.artifact import export_serving, load_artifact, save_artifact

    cfg = models.get_model_config("uit_xxxs", outputdim=7, target_length=102, depth=1)
    model = models.build(cfg, torch.Generator().manual_seed(1), device="cpu")
    path = save_artifact(tmp_path / "m.uitx", export_serving(
        cfg, model, batch_size=3, dtype="int16", use_kernel=True, device="cpu"), cfg=cfg)
    fn, _ = load_artifact(path, device="cpu")
    wav = torch.from_numpy(np.random.default_rng(6).integers(-9000, 9000, (3, SR),
                                                             dtype=np.int16))
    reads = []

    class HostReads(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if func is torch.ops.aten._local_scalar_dense.default:
                reads.append(func)
            return func(*args, **(kwargs or {}))

    with HostReads():
        got = fn(wav)
    assert not reads and fn.graphs is None
    assert torch.equal(got, fn.eager(wav))
    with torch.inference_mode():
        assert torch.equal(got, fn.program.module()(wav))


def test_artifact_constant_copies_fold_into_device_constants_bitwise(monkeypatch):
    """A plain batch-polymorphic artifact whose frontend's window and
    filterbank were first built under the trace copies them, lifted host
    constants, to the device at each call (from pageable memory, which a
    capture refuses); the card's load folds the copies into constants made
    once. The program's output stays bitwise (folded here for the CPU, as
    load_artifact folds them for the card)."""
    from uit_mobile_tpu_torch.ckpt.artifact import _constants_on_device, export_serving
    from uit_mobile_tpu_torch.utils import device as device_mod

    monkeypatch.setattr(device_mod, "_CONSTANTS", {})  # none built before the trace

    cfg = models.get_model_config("uit_xxxs", outputdim=7, target_length=102, depth=1)
    model = models.build(cfg, torch.Generator().manual_seed(2), device="cpu")
    module = export_serving(cfg, model, n_samples=3 * SR, dtype="int16",
                            device="cpu").program.module()
    wav = torch.from_numpy(np.random.default_rng(7).integers(-9000, 9000, (2, 3 * SR),
                                                             dtype=np.int16))
    with torch.inference_mode():
        want = module(wav)
        assert _constants_on_device(module, torch.device("cpu")) == 2
        assert torch.equal(module(wav), want)
    assert not any(n.target is torch.ops.aten.to.device for n in module.graph.nodes
                   if n.args and getattr(n.args[0], "op", None) == "get_attr")
