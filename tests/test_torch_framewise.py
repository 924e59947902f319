"""Temporal tagging in the port (models.apply_framewise, framewise_times,
forward_head_framewise, ops.pipeline.make_framewise_fn) against the JAX
package on the CPU, the same weights carried with ckpt.convert: UiT with
mean, token and dm pooling on one window and on three (the tail window
overlapping), and MobileNetV2. Probabilities within 1e-5 (the tolerance of
tests/test_torch_uit.py), times bitwise; the mean over segments equals the
port's clip forward within 1e-6 (tests/test_framewise.py:31)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ops import make_frontend_fn as jax_make_frontend_fn
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.models import uit
from uit_mobile_tpu_torch.ops import make_framewise_fn

torch.set_num_threads(1)


def _carry(name, **kw):
    jcfg = jax_models.get_model_config(name, **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    cfg = models.get_model_config(name, **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    return jcfg, params, state, cfg, model


def _noise(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.fixture(scope="module", params=["mean", "token", "dm"])
def carried(request):
    return _carry("uit_xxxs", outputdim=13, target_length=102, depth=2, pooling=request.param)


@pytest.mark.parametrize("T, n_seg", [(16000, 1), (40000, 3)])
def test_uit_framewise_matches_jax(carried, T, n_seg):
    jcfg, params, state, cfg, model = carried
    wav = _noise((2, T), seed=T)
    want_p, want_t = jax_models.apply_framewise(jcfg, params, state, jnp.asarray(wav))
    got_p, got_t = models.apply_framewise(cfg, model, torch.from_numpy(wav))
    if cfg.pooling == "dm":
        n_seg *= 6  # six 0.16 s time patches a window
    assert got_p.shape == (2, n_seg, 13) and got_t.dtype == np.float64
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=0)
    assert np.array_equal(got_t, want_t)
    clip = models.apply(cfg, model, torch.from_numpy(wav))
    torch.testing.assert_close(got_p.mean(dim=1), clip, atol=1e-6, rtol=0)


@pytest.mark.parametrize("n_frames", [16, 101, 102, 251, 1001])
def test_framewise_times_match_jax(carried, n_frames):
    jcfg, _, _, cfg, _ = carried
    got = uit.framewise_times(cfg, n_frames)
    want = jax_models.uit.framewise_times(jcfg, n_frames)
    assert got.dtype == np.float64 and np.array_equal(got, want)


def test_framewise_head_mean_is_clip_head():
    _, _, _, cfg, model = _carry("uit_xxxs", outputdim=7, target_length=102, depth=1,
                                 pooling="dm")
    x = torch.from_numpy(_noise((3, cfg.grid_size[0] * cfg.grid_size[1], 128), seed=4))
    with torch.inference_mode():
        per_t = uit.forward_head_framewise(cfg, model, x)
        torch.testing.assert_close(per_t.mean(dim=1), uit.forward_head(cfg, model, x),
                                   atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="dm"):
        uit.forward_head_framewise(dataclasses.replace(cfg, pooling="mean"), model, x)


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_kernel_framewise_fn_matches_jax(precision):
    """make_framewise_fn on the kernel path (its plain version here, per-sample
    dB clamp, as Evaluator.strong runs it) against the JAX framewise forward
    with the Pallas frontend in interpret mode."""
    jcfg, params, state, cfg, model = _carry("uit_xxxs", outputdim=13, target_length=102,
                                             depth=2)
    wav = _noise((3, 32000), seed=5)
    wav[2] *= 1e-3  # a quiet clip: its own dB clamp, not the batch's
    fe = jax_make_frontend_fn(dataclasses.replace(jcfg.frontend, top_db_mode="per_sample"),
                              use_pallas=True, precision=precision)
    want_p, want_t = jax_models.apply_framewise(jcfg, params, state, jnp.asarray(wav),
                                                frontend_fn=fe)
    fn = make_framewise_fn(cfg, model, use_kernel=True, precision=precision,
                           top_db_mode="per_sample")
    got_p, got_t = fn(wav)
    assert fn.uses_kernel and fn.top_db_mode == "per_sample"
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=0)
    assert np.array_equal(got_t, want_t)


def test_mobilenetv2_framewise_matches_jax():
    jcfg, params, state, cfg, model = _carry("MobileNetV2", outputdim=9)
    assert models.mobilenetv2.total_time_stride(cfg) == 32
    wav = _noise((2, 16000), seed=2)
    want_p, want_t = jax_models.apply_framewise(jcfg, params, state, jnp.asarray(wav))
    got_p, got_t = models.apply_framewise(cfg, model, torch.from_numpy(wav))
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), atol=1e-5, rtol=0)
    assert np.array_equal(got_t, want_t)
    np.testing.assert_allclose(got_t[:, 1] - got_t[:, 0], 0.32)
    clip = models.apply(cfg, model, torch.from_numpy(wav))
    torch.testing.assert_close(got_p.mean(dim=1), clip, atol=1e-6, rtol=0)
