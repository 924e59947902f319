"""SED's train-side model functions in the port (models/uit.py
forward_train_framewise, train/steps.py make_framewise_train_step) against
the JAX package on the CPU (the dataset and trainer: tests/test_torch_sed.py).

Tolerances (those of the weak path's parity tests): the framewise train
forward's probabilities 1e-5 and its init_bn state 1e-6; one framewise
step under SGD: loss 1e-5 relative, pre-clip gradient norm 1e-4 relative,
updated parameters 1e-6; the framewise mean against the clip head 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.train.steps import make_framewise_train_step as jax_framewise_step
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.models import uit as uit_model
from uit_mobile_tpu_torch.train import build_optimizer
from uit_mobile_tpu_torch.train.steps import make_framewise_train_step

torch.set_num_threads(1)
SR = 16000


def _cfgs(depth=1):
    kw = dict(outputdim=10, target_length=102, depth=depth, pooling="dm")
    return jax_models.get_model_config("uit_xxxs", **kw), models.get_model_config("uit_xxxs", **kw)


def test_forward_train_framewise_matches_jax():
    jcfg, cfg = _cfgs(depth=2)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    wav = (np.random.default_rng(1).standard_normal((4, SR)) * 0.1).astype(np.float32)
    got, new_state = uit_model.forward_train_framewise(cfg, model, torch.from_numpy(wav))
    want, want_state = jax_models.uit.forward_train_framewise(
        jcfg, params, state, jnp.asarray(wav), rng=jax.random.key(0))
    assert got.shape == (4, 6, 10)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[f"init_bn.{k}"].numpy(),
                                   np.asarray(want_state["init_bn"][k]), atol=1e-6, rtol=1e-6)
    # the framewise mean is the clip-level dm head
    fw, times = models.apply_framewise(cfg, model, torch.from_numpy(wav))
    clip = models.apply(cfg, model, torch.from_numpy(wav))
    np.testing.assert_allclose(fw.mean(dim=1).numpy(), clip.numpy(), atol=1e-6, rtol=0)
    assert times.shape == (6, 2)
    with pytest.raises(ValueError, match="single-window"):
        uit_model.forward_train_framewise(cfg, model, torch.zeros(2, 3 * SR))


def test_framewise_step_matches_jax():
    jcfg, cfg = _cfgs(depth=1)
    params, state = jax_models.build(jcfg, jax.random.key(2))
    rng = np.random.default_rng(2)
    batch = {"wav": rng.integers(-20000, 20000, (4, SR), np.int16),
             "target": (rng.random((4, 6, 10)) < 0.2).astype(np.float32)}
    opt = optax.sgd(0.1)
    step = jax_framewise_step(jcfg, opt, max_grad_norm=1.0)
    new_p, new_s, _, m = step(params, state, opt.init(params),
                              {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.key(1))
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    optimizer = build_optimizer("SGD", 0.1).init(model)
    got = make_framewise_train_step(cfg, model, optimizer, max_grad_norm=1.0)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got["total_loss"].item() == pytest.approx(float(m["total_loss"]), rel=1e-5)
    assert got["grad_norm"].item() == pytest.approx(float(m["grad_norm"]), rel=1e-4)
    mine = flatten_tree(module_to_numpy(model)[0], "/")
    want = flatten_tree(jax.tree.map(np.asarray, new_p), "/")
    assert mine.keys() == want.keys()
    assert max(np.abs(mine[k] - want[k]).max() for k in mine) <= 1e-6
    np.testing.assert_allclose(model.init_bn.mean.numpy(),
                               np.asarray(new_s["init_bn"]["mean"]), atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="segment grid mismatch"):
        make_framewise_train_step(cfg, model, optimizer)(
            {"wav": torch.zeros(2, SR), "target": torch.zeros(2, 5, 10)})
