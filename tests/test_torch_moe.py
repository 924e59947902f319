"""The port's MoE UiT (uit_mobile_tpu_torch.models.moe) and its train step
(parallel/ep.py) against the JAX package's on the CPU.

JAX ``models.build`` weights of a small MoE (depth 2, outputdim 37, 4
experts) are carried into the port with ``module_from_numpy``; both
forwards see the same numpy wave. Tolerances (measured on the CPU: float32
forwards 6e-8 to 1.2e-7 apart): eval and train forwards 1e-5, aux 1e-5
relative, BN running statistics 1e-6; identical experts vs the dense port
UiT 2e-5 (the JAX test's bound: the combine weights sum to 1 only within
rounding); bfloat16 vs JAX's bfloat16 2e-3, the port's bf16 budget
(tests/test_torch_bf16.py); one train step under AdamW: loss 1e-5
relative, aux 1e-5 relative, gradients 1e-5 of each tensor's largest,
params 1e-6 outside the elements whose gradient is below 1e-7 (Adam's first
step is +-lr there whatever the sign of a rounding; counted, under 1 %)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.models import moe as jax_moe
from uit_mobile_tpu.parallel import make_moe_train_step as jax_make_moe_train_step
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.models import moe
from uit_mobile_tpu_torch.ops import make_forward_fn
from uit_mobile_tpu_torch.parallel import make_moe_train_step
from uit_mobile_tpu_torch.train import build_optimizer

torch.set_num_threads(1)


def _carry(**kw):
    kw.setdefault("n_experts", 4)
    kw = dict(outputdim=37, target_length=102, depth=2, **kw)
    jcfg = jax_models.get_model_config("uit_xs_moe", **kw)
    params, state = jax.tree.map(
        np.asarray, jax.jit(jax_models.build, static_argnums=0)(jcfg, jax.random.key(0)))
    cfg = models.get_model_config("uit_xs_moe", **kw)
    return jcfg, params, state, cfg, module_from_numpy(cfg, params, state, "cpu")


@pytest.fixture(scope="module")
def carried():
    return _carry()


def _wav(b, seed=0, t=16000):
    return (np.random.default_rng(seed).standard_normal((b, t)) * 0.1).astype(np.float32)


def _jax_probs(jcfg, params, state, wav):
    fwd = jax.jit(lambda p, s, w: jax_models.apply(jcfg, p, s, w))
    return np.asarray(fwd(params, state, jnp.asarray(wav)))


def test_registry_init_and_forward_match_jax(carried):
    jcfg, params, state, cfg, model = carried
    assert isinstance(cfg, models.MoEUITConfig) and cfg.base.depth == 2
    # the port's own init gives the JAX tree's keys and shapes
    own = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(0), "cpu"))
    for a, b in zip(jax.tree_util.tree_flatten_with_path(own)[0],
                    jax.tree_util.tree_flatten_with_path((params, state))[0]):
        assert a[0] == b[0] and a[1].shape == b[1].shape
    wav = _wav(3)
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    assert got.shape == (3, 37)
    np.testing.assert_allclose(got, _jax_probs(jcfg, params, state, wav), atol=1e-5, rtol=0)


def test_long_clip_crop_path_matches_jax(carried):
    jcfg, params, state, cfg, model = carried
    wav = _wav(2, seed=1, t=3 * 16000)  # 3 windows, the last one overlapping
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, _jax_probs(jcfg, params, state, wav), atol=1e-5, rtol=0)


def test_train_forward_aux_and_new_state_match_jax(carried):
    jcfg, params, state, cfg, model = carried
    wav = _wav(3, seed=2)
    jp, jaux, jstate = jax.jit(lambda p, s, w: jax_moe.forward_with_aux(
        jcfg, p, s, w, train=True))(params, state, jnp.asarray(wav))
    probs, aux, new_state = moe.forward_with_aux(cfg, model, torch.from_numpy(wav),
                                                 train=True)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(jp), atol=1e-5, rtol=0)
    assert aux.item() == pytest.approx(float(jaux), rel=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[f"init_bn.{k}"].numpy(),
                                   np.asarray(jstate["init_bn"][k]), atol=1e-6, rtol=0)
    # the module itself is not changed by a train forward
    assert np.array_equal(model.init_bn.mean.numpy(), state["init_bn"]["mean"])


def test_identical_experts_match_the_dense_port_uit():
    """Every expert holding the same weights: routing is a convex combination
    of identical outputs (ample capacity), so the MoE is the dense UiT whose
    MLP is that expert."""
    _, params, state, cfg, _ = _carry(capacity_factor=8.0)
    dense = {k: v for k, v in params.items() if k != "blocks"}
    dense["blocks"] = []
    for blk in params["blocks"]:
        e = blk["moe"]
        for name in ("fc1", "fc2"):
            for leaf in ("kernel", "bias"):
                e[name][leaf] = np.repeat(e[name][leaf][:1], cfg.n_experts, axis=0)
        d = {k: v for k, v in blk.items() if k != "moe"}
        d["mlp"] = {n: {leaf: e[n][leaf][0] for leaf in ("kernel", "bias")}
                    for n in ("fc1", "fc2")}
        dense["blocks"].append(d)
    model = module_from_numpy(cfg, params, state, "cpu")
    dense_model = module_from_numpy(cfg.base, dense, state, "cpu")
    wav = torch.from_numpy(_wav(3, seed=3))
    np.testing.assert_allclose(models.apply(cfg, model, wav).numpy(),
                               models.apply(cfg.base, dense_model, wav).numpy(),
                               atol=2e-5, rtol=0)


def test_dropped_tokens_match_jax_at_capacity_quarter():
    jcfg, params, state, cfg, model = _carry(capacity_factor=0.25)
    x = np.random.default_rng(4).standard_normal((4, 24, 128)).astype(np.float32)
    with torch.no_grad():
        y, aux = moe.moe_mlp(cfg, model.blocks[0].moe, torch.from_numpy(x))
    jy, jaux = jax.jit(lambda p, x: jax_moe.moe_mlp(jcfg, p, x))(params["blocks"][0]["moe"],
                                                                 jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    # the capacity really binds: some tokens pass through with a zero MLP output
    dropped = int((y.abs().sum(-1) == 0).sum())
    assert dropped > 0 and dropped == int((np.abs(np.asarray(jy)).sum(-1) == 0).sum())
    wav = _wav(4, seed=2)
    np.testing.assert_allclose(models.apply(cfg, model, torch.from_numpy(wav)).numpy(),
                               _jax_probs(jcfg, params, state, wav), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kw", [{"group_size": 24}, {"top_k": 1}])
def test_group_size_and_top1_routing_match_jax(kw):
    jcfg, params, state, cfg, model = _carry(**kw)
    wav = _wav(3, seed=9)
    np.testing.assert_allclose(models.apply(cfg, model, torch.from_numpy(wav)).numpy(),
                               _jax_probs(jcfg, params, state, wav), atol=1e-5, rtol=0)


def test_group_size_must_divide_the_tokens():
    cfg = models.get_model_config("uit_xs_moe", outputdim=37, target_length=102, depth=2,
                                  n_experts=4, group_size=7)
    model = models.build(cfg, device="cpu")
    with pytest.raises(ValueError, match="divide"):
        models.apply(cfg, model, torch.from_numpy(_wav(3)))


def test_uniform_router_aux_is_one_and_ties_take_the_lower_index(carried):
    """Uniform gates: P_e = 1/E and, with ties broken toward the lower
    index, every token's top-1 is expert 0: f = (1, 0, ...), aux = 1."""
    jcfg, params, _, cfg, model = carried
    x = np.random.default_rng(4).standard_normal((1, 24, 128)).astype(np.float32)
    with torch.no_grad():
        blk_zero = moe.MoE(cfg)
        blk_zero.load_state_dict(model.blocks[0].moe.state_dict())
        blk_zero.router.kernel.zero_()
        y, aux = moe.moe_mlp(cfg, blk_zero, torch.from_numpy(x))
    assert float(aux) == pytest.approx(1.0, abs=1e-5)
    zeroed = dict(params["blocks"][0]["moe"],
                  router={"kernel": np.zeros_like(params["blocks"][0]["moe"]["router"]["kernel"])})
    jy, _ = jax_moe.moe_mlp(jcfg, zeroed, jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    values, idx = moe._top_k(torch.tensor([[0.25, 0.5, 0.25, 0.5]]), 3)
    assert idx.tolist() == [[1, 3, 0]] and values.tolist() == [[0.5, 0.5, 0.25]]


def test_bf16_matches_jax_bf16():
    jcfg, params, state, cfg, model = _carry(compute_dtype="bfloat16")
    wav = _wav(3, seed=5)
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    want = _jax_probs(jcfg, params, state, wav)
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    f32 = _carry()
    drift = np.abs(got - models.apply(f32[3], f32[4], torch.from_numpy(wav)).numpy()).max()
    assert 0 < drift <= 5e-3  # bfloat16 really engaged


def test_moe_train_step_matches_jax_adamw():
    jcfg, params, state, cfg, model = _carry()
    wav = _wav(4, seed=6)
    target = (np.random.default_rng(7).uniform(size=(4, 37)) > 0.8).astype(np.float32)
    jopt = optax.adamw(1e-3, weight_decay=1e-2)
    jp = jax.tree.map(jnp.asarray, params)
    js = jopt.init(jp)
    jstep = jax.jit(jax_make_moe_train_step(jcfg, jopt))
    jp2, jstate2, js2, jm = jstep(jp, jax.tree.map(jnp.asarray, state), js, jnp.asarray(wav),
                                  jnp.asarray(target), jax.random.key(1))
    opt = build_optimizer("AdamW", 1e-3).init(model)
    m = make_moe_train_step(cfg, model, opt)(torch.from_numpy(wav), torch.from_numpy(target))
    for k in ("total_loss", "bce", "aux", "grad_norm"):
        assert m[k].item() == pytest.approx(float(jm[k]), rel=1e-5), k
    # the first AdamW update's first moment is (1 - b1) x the gradient
    jgrads = {".".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path): leaf / 0.1
              for path, leaf in jax.tree_util.tree_flatten_with_path(js2[0].mu)[0]}
    small = 0
    for (name, p), mu in zip(model.named_parameters(), opt.moments[0]):
        g, want = mu.numpy() / 0.1, np.asarray(jgrads[name])
        assert np.abs(g - want).max() <= 1e-5 * max(np.abs(want).max(), 1e-30), name
        # Adam's first step is +-lr * g / (|g| + eps): where |g| < 1e-7 a
        # rounding of g moves it by up to lr, so those elements are counted
        # and left out, as in tests/test_torch_steps.py
        keep = (np.abs(want) >= 1e-7) | (want == 0)
        small += int((~keep).sum())
        np.testing.assert_allclose(p.detach().numpy()[keep], np.asarray(_leaf(jp2, name))[keep],
                                   atol=1e-6, rtol=0, err_msg=name)
    assert small < 1e-2 * sum(p.numel() for p in model.parameters())  # 0.25 % here
    np.testing.assert_allclose(model.init_bn.mean.numpy(),
                               np.asarray(jstate2["init_bn"]["mean"]), atol=1e-6, rtol=0)


def _leaf(tree, dotted: str):
    for k in dotted.split("."):
        tree = tree[int(k)] if isinstance(tree, list) else tree[k]
    return tree


def test_dense_step_rejects_moe_and_moe_has_no_framewise(carried):
    from uit_mobile_tpu_torch.serve import make_framewise_fn
    from uit_mobile_tpu_torch.train import make_train_step

    _, _, _, cfg, model = carried
    with pytest.raises(TypeError, match="make_moe_train_step"):
        make_train_step(cfg, model, build_optimizer("AdamW", 1e-3).init(model))
    with pytest.raises(TypeError):
        models.apply_framewise(cfg, model, torch.zeros(1, 16000))
    with pytest.raises(TypeError):
        make_framewise_fn(cfg, model, device="cpu")


def test_pipeline_serves_the_moe_as_a_bft_consumer(carried):
    """make_forward_fn with the kernel's plain version on the CPU: 'tfb_to_bft'
    (the row kernel below TFB_MIN_BATCH), the MoE's frontend config carried
    through its base; within 1e-4 of the JAX forward (the exact kernel vs
    the rfft frontend)."""
    jcfg, params, state, cfg, model = carried
    fwd = make_forward_fn(cfg, model, use_kernel=True, precision="exact",
                          top_db_mode="per_sample")
    assert fwd.uses_kernel and fwd.top_db_mode == "per_sample"
    wav = _wav(3, seed=8)
    jfe = dataclasses.replace(jcfg.base.frontend, top_db_mode="per_sample")
    jrun = dataclasses.replace(jcfg, base=dataclasses.replace(jcfg.base, frontend=jfe))
    np.testing.assert_allclose(fwd(wav).numpy(), _jax_probs(jrun, params, state, wav),
                               atol=1e-4, rtol=0)
