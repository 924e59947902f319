"""``compute_dtype: bfloat16`` in the port's UiT encoder (models/uit.py)
against the JAX package's bfloat16 on the CPU, with the JAX weights carried
by ckpt/convert.py (the teacher's: tests/test_torch_bf16_teacher.py).

Tolerances: the port's bfloat16 probabilities within 2e-3 of JAX's
bfloat16 (the encoder's bfloat16 matmuls round in both); the port's
bfloat16 against its own float32: drift > 0 (bfloat16 engaged) and <=
5e-3, the JAX budget (tests/test_mobilenetv2.py:172). The same bounds hold
for the eval, train and framewise forwards and one train step's loss.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.models import uit as uit_model
from uit_mobile_tpu_torch.train import build_optimizer, make_train_step

torch.set_num_threads(1)
VS_JAX, DRIFT = 2e-3, 5e-3


def _bf16(cfg):
    return dataclasses.replace(cfg, compute_dtype="bfloat16")


@pytest.fixture(scope="module")
def carried():
    """{pooling: (jax cfg, params, state, port cfg, port model)}, depth 2."""
    out = {}
    for pooling in ("mean", "dm"):
        kw = dict(outputdim=21, target_length=102, depth=2, pooling=pooling)
        jcfg = jax_models.get_model_config("uit_xxxs", **kw)
        params, state = jax_models.build(jcfg, jax.random.key(0))
        cfg = models.get_model_config("uit_xxxs", **kw)
        model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), device="cpu")
        out[pooling] = (jcfg, params, state, cfg, model)
    return out


def _wav(B, seconds=1, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, seconds * 16000))
            * 0.1).astype(np.float32)


def _check(port_bf16, jax_bf16, port_f32):
    port_bf16, jax_bf16, port_f32 = (np.asarray(x, np.float32)
                                     for x in (port_bf16, jax_bf16, port_f32))
    assert port_bf16.shape == jax_bf16.shape == port_f32.shape
    vs_jax = np.abs(port_bf16 - jax_bf16).max()
    drift = np.abs(port_bf16 - port_f32).max()
    assert vs_jax <= VS_JAX and 0 < drift <= DRIFT, (vs_jax, drift)


@pytest.mark.parametrize("pooling, seconds", [("mean", 1), ("mean", 3), ("dm", 1)])
def test_eval_forward_matches_jax(carried, pooling, seconds):
    jcfg, params, state, cfg, model = carried[pooling]
    wav = _wav(4, seconds)
    got = models.apply(_bf16(cfg), model, torch.from_numpy(wav))
    assert got.dtype == torch.float32
    _check(got, jax_models.apply(_bf16(jcfg), params, state, jnp.asarray(wav)),
           models.apply(cfg, model, torch.from_numpy(wav)))


def test_tfb_eval_forward_equals_bft(carried):
    """The serving layout of the bfloat16 frontier: tfb against bft."""
    from uit_mobile_tpu_torch.ops import make_frontend_fn

    _, _, _, cfg, model = carried["mean"]
    wav = torch.from_numpy(_wav(4))
    tfb = dataclasses.replace(_bf16(cfg), mel_layout="tfb")
    got = models.apply(tfb, model, wav, frontend_fn=make_frontend_fn(
        cfg.frontend, use_kernel=False, layout="tfb"))
    want = models.apply(_bf16(cfg), model, wav)
    assert (got - want).abs().max().item() <= VS_JAX


def test_train_forward_matches_jax(carried):
    jcfg, params, state, cfg, model = carried["mean"]
    wav = _wav(6, seed=1)
    got, new_state = models.apply(_bf16(cfg), model, torch.from_numpy(wav), train=True)
    want, want_state = jax_models.apply(_bf16(jcfg), params, state, jnp.asarray(wav),
                                        train=True)
    f32, _ = models.apply(cfg, model, torch.from_numpy(wav), train=True)
    _check(got.detach(), want, f32.detach())
    np.testing.assert_allclose(new_state["init_bn.var"].numpy(),
                               np.asarray(want_state["init_bn"]["var"]), rtol=1e-5)


def test_framewise_forwards_match_jax(carried):
    jcfg, params, state, cfg, model = carried["dm"]
    wav = _wav(4, seed=2)
    got, times = models.apply_framewise(_bf16(cfg), model, torch.from_numpy(wav))
    want, want_times = jax_models.uit.forward_framewise(_bf16(jcfg), params, state,
                                                        jnp.asarray(wav))
    f32, _ = models.apply_framewise(cfg, model, torch.from_numpy(wav))
    _check(got, want, f32)
    np.testing.assert_array_equal(times, want_times)
    got, _ = uit_model.forward_train_framewise(_bf16(cfg), model, torch.from_numpy(wav))
    want, _ = jax_models.uit.forward_train_framewise(_bf16(jcfg), params, state,
                                                     jnp.asarray(wav), rng=jax.random.key(0))
    f32, _ = uit_model.forward_train_framewise(cfg, model, torch.from_numpy(wav))
    _check(got.detach(), want, f32.detach())


def test_train_step_loss_matches_jax(carried):
    """The port's step loss against the JAX loss of the same train forward
    (the step's loss; the JAX step itself would only add an XLA compile)."""
    from uit_mobile_tpu.train.steps import make_loss as jax_make_loss

    jcfg, params, state, cfg, _ = carried["mean"]
    wav = _wav(4, seed=3)
    target = (np.random.default_rng(4).uniform(size=(4, 21)) > 0.7).astype(np.float32)
    probs, _ = jax_models.apply(_bf16(jcfg), params, state, jnp.asarray(wav), train=True)
    want = float(jax_make_loss("BCELoss")(probs, jnp.asarray(target)))
    losses = {}
    for name, c in (("bf16", _bf16(cfg)), ("f32", cfg)):
        model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                  jax.tree.map(np.asarray, state), device="cpu")
        opt = build_optimizer("AdamW", 1e-3).init(model)
        out = make_train_step(c, model, opt)({"wav": torch.from_numpy(wav),
                                              "target": torch.from_numpy(target)})
        losses[name] = out["total_loss"].item()
        assert np.isfinite(out["grad_norm"].item())
    _check([losses["bf16"]], [want], [losses["f32"]])
