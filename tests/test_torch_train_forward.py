"""The port's train forward (models/common.py batch_norm_train, models/uit.py
train branches) against the JAX package on the CPU, with the JAX weights
carried by ckpt/convert.py.

The stochastic parts are off in the parity tests (JAX keys and torch
generators draw different numbers) and the mixup lambdas are passed in.
Tolerances: batch_norm_train outputs 1e-6, new state 1e-7; the UiT train
forward probs 1e-5, init_bn state 1e-6; the port's tfb train forward equal
to its bft one within the JAX package's own tfb-vs-bft bound
(tests/test_tfb_train.py:116, atol 2e-5 / rtol 1e-4)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.models.common import batch_norm_train as jax_bn_train
from uit_mobile_tpu.ops import make_frontend_fn as jax_make_frontend_fn
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.augment import parse_spectransforms, parse_wavtransforms
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.models.common import BatchNorm, batch_norm_train
from uit_mobile_tpu_torch.models.uit import _drop_patches
from uit_mobile_tpu_torch.ops import make_frontend_fn

torch.set_num_threads(1)
B = 6


def _carry(**kw):
    kw = dict(outputdim=21, target_length=102, depth=2, **kw)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    cfg = models.get_model_config("uit_xxxs", **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    return jcfg, params, state, cfg, model


@pytest.fixture(scope="module")
def carried():
    return _carry()


def _wav(seed=0):
    return (np.random.default_rng(seed).standard_normal((B, 16000)) * 0.1).astype(np.float32)


@pytest.mark.parametrize("momentum", [0.1, 0.01])
@pytest.mark.parametrize("axis, shape", [(-2, (4, 64, 101)), (1, (101, 64, 4)),
                                         (1, (4, 24, 8, 13))])
def test_batch_norm_train_matches_jax(momentum, axis, shape):
    # unit-scale values (|y| < 8, state < 1), where float32's spacing is
    # below the tolerances: the two sum the batch statistics in other orders
    r = np.random.default_rng(1)
    x = (r.standard_normal(shape) * 0.5 + 0.1).astype(np.float32)
    C = shape[axis]
    p = {"scale": r.uniform(0.5, 1.5, C).astype(np.float32),
         "bias": (r.standard_normal(C) * 0.5).astype(np.float32)}
    s = {"mean": (r.standard_normal(C) * 0.5).astype(np.float32),
         "var": r.uniform(0.2, 0.6, C).astype(np.float32)}
    y_j, s_j = jax_bn_train(jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, s),
                            jnp.asarray(x), axis=axis, momentum=momentum)
    bn = BatchNorm(C)
    with torch.no_grad():
        for k, v in {**p, **s}.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    y, new = batch_norm_train(bn, torch.from_numpy(x), axis=axis, momentum=momentum)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j), atol=1e-6, rtol=0)
    for k in ("mean", "var"):
        np.testing.assert_allclose(new[k].numpy(), np.asarray(s_j[k]), atol=1e-7, rtol=1e-7)
        assert not new[k].requires_grad
    assert torch.equal(bn.mean, torch.from_numpy(s["mean"]))  # the module is untouched


@pytest.mark.parametrize("layout", ["bft", "tfb"])
@pytest.mark.parametrize("mixup", [False, True])
def test_uit_train_forward_matches_jax(layout, mixup):
    jcfg, params, state, cfg, model = _carry(mel_layout=layout)
    wav = _wav()
    lamb = np.random.default_rng(2).beta(0.3, 0.3, B).astype(np.float32) if mixup else None
    fe_j = jax_make_frontend_fn(jcfg.frontend, use_pallas=False, layout=layout)
    p_j, s_j = jax_models.apply(jcfg, params, state, jnp.asarray(wav), train=True,
                                rng=jax.random.key(0), frontend_fn=fe_j,
                                mixup_lamb=None if lamb is None else jnp.asarray(lamb))
    fe = make_frontend_fn(cfg.frontend, use_kernel=False, layout=layout)
    probs, new_state = models.apply(cfg, model, torch.from_numpy(wav), train=True,
                                    generator=torch.Generator().manual_seed(0), frontend_fn=fe,
                                    mixup_lamb=None if lamb is None else torch.from_numpy(lamb))
    assert probs.requires_grad and probs.shape == (B, 21)
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(p_j), atol=1e-5, rtol=0)
    assert set(new_state) == {"init_bn.mean", "init_bn.var"}
    for k in ("mean", "var"):
        np.testing.assert_allclose(new_state[f"init_bn.{k}"].numpy(),
                                   np.asarray(s_j["init_bn"][k]), atol=1e-6, rtol=0)
    # the train forward leaves the buffers alone; load_state writes them
    assert torch.equal(model.init_bn.mean, torch.zeros(64))
    models.load_state(model, new_state)
    assert torch.equal(model.init_bn.var, new_state["init_bn.var"])


def test_uit_train_forward_without_init_bn_matches_jax():
    jcfg, params, state, cfg, model = _carry(init_bn=False)
    wav = _wav(3)
    p_j, _ = jax_models.apply(jcfg, params, state, jnp.asarray(wav), train=True,
                              rng=jax.random.key(0))
    probs, new_state = models.apply(cfg, model, torch.from_numpy(wav), train=True)
    assert new_state == {}
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(p_j), atol=1e-5, rtol=0)


def _spec_aug(layout):
    return parse_spectransforms([{"TimeMasking": {"time_mask_param": 20}},
                                 {"FrequencyMasking": {"freq_mask_param": 8}}], layout=layout)


@pytest.mark.parametrize("kernel", [False, True])
def test_tfb_train_forward_equals_bft_in_port(carried, kernel):
    """Same weights, wave, generator seed, mixup and spec masks: the tfb train
    branch (patch_embed_tfb_train, BN over axis 1) agrees with bft. With
    ``kernel`` the frontends are the fused mel wrapper (its plain version
    here on the CPU)."""
    _, _, _, cfg_b, model = carried
    cfg_t = dataclasses.replace(cfg_b, mel_layout="tfb")
    wav = torch.from_numpy(_wav(4))
    lamb = torch.from_numpy(np.random.default_rng(5).beta(0.3, 0.3, B).astype(np.float32))
    out = {}
    for cfg in (cfg_b, cfg_t):
        fe = make_frontend_fn(cfg.frontend, use_kernel=kernel, layout=cfg.mel_layout)
        out[cfg.mel_layout] = models.apply(
            cfg, model, wav, train=True, generator=torch.Generator().manual_seed(9),
            mixup_lamb=lamb, spec_augment=_spec_aug(cfg.mel_layout), frontend_fn=fe)
    (pb, sb), (pt, st) = out["bft"], out["tfb"]
    torch.testing.assert_close(pt, pb, atol=2e-5, rtol=1e-4)
    for k in sb:
        torch.testing.assert_close(st[k], sb[k], atol=1e-5, rtol=1e-5)


def test_int16_train_forward_bitwise_f32(carried):
    """Raw int16 PCM (no wav augment) trains bitwise as f32/32768, in the
    rfft frontend and the kernel wrapper's plain version."""
    _, _, _, cfg, model = carried
    pcm = np.clip(np.rint(_wav(6) * 32768), -32768, 32767).astype(np.int16)
    for fe in (None, make_frontend_fn(cfg.frontend, layout="bft")):
        p_i, s_i = models.apply(cfg, model, torch.from_numpy(pcm), train=True, frontend_fn=fe)
        p_f, s_f = models.apply(cfg, model, torch.from_numpy(pcm.astype(np.float32) / 32768.0),
                                train=True, frontend_fn=fe)
        assert torch.equal(p_i, p_f)
        assert all(torch.equal(s_i[k], s_f[k]) for k in s_i)


def test_train_guards_raise_as_in_jax(carried):
    _, _, _, cfg, model = carried
    wav = torch.from_numpy(_wav(7))
    g = torch.Generator().manual_seed(0)
    tfb = dataclasses.replace(cfg, mel_layout="tfb")
    fe_t = make_frontend_fn(cfg.frontend, use_kernel=False, layout="tfb")
    with pytest.raises(ValueError, match="btf.*eval/serving"):
        models.apply(dataclasses.replace(cfg, mel_layout="btf"), model, wav, train=True)
    with pytest.raises(ValueError, match="needs a frontend_fn"):
        models.apply(tfb, model, wav, train=True)
    with pytest.raises(ValueError, match="layout='tfb'"):
        models.apply(tfb, model, wav, train=True, generator=g, frontend_fn=fe_t,
                     spec_augment=_spec_aug("bft"))
    with pytest.raises(ValueError, match="layout='bft'"):
        models.apply(cfg, model, wav, train=True, generator=g, spec_augment=_spec_aug("tfb"))
    pcm = (wav * 3000).to(torch.int16)
    with pytest.raises(ValueError, match="wav augments"):
        models.apply(cfg, model, pcm, train=True, generator=g,
                     wav_augment=parse_wavtransforms({"Gain": {"p": 1.0}}))
    lengths = torch.full((B,), 12000)
    masked = dataclasses.replace(cfg, use_length_mask=True)
    with pytest.raises(ValueError, match="incompatible with mixup"):
        models.apply(masked, model, wav, train=True, lengths=lengths,
                     mixup_lamb=torch.full((B,), 0.5))
    with pytest.raises(ValueError, match="patch_out"):
        models.apply(dataclasses.replace(masked, time_patch_out=0.2), model, wav, train=True,
                     generator=g, lengths=lengths)
    with pytest.raises(ValueError, match="only implemented on the canonical 'bft'"):
        models.apply(dataclasses.replace(masked, mel_layout="tfb"), model, wav, train=True,
                     lengths=lengths, frontend_fn=fe_t)
    with pytest.raises(ValueError, match="positional embeddings"):
        models.apply(cfg, model, torch.zeros(2, 48000), train=True)
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(cfg, compute_dtype="float16")
    # bfloat16 compute trains (tests/test_torch_bf16.py holds it against JAX)
    probs, _ = models.apply(dataclasses.replace(cfg, compute_dtype="bfloat16"), model, wav,
                            train=True)
    assert torch.isfinite(probs).all() and probs.dtype == torch.float32


def test_length_mask_train_matches_jax():
    jcfg, params, state, cfg, model = _carry(use_length_mask=True)
    wav, lengths = _wav(8), np.array([16000, 9000, 12000, 4000, 16000, 7000])
    p_j, _ = jax_models.apply(jcfg, params, state, jnp.asarray(wav), train=True,
                              rng=jax.random.key(0), lengths=jnp.asarray(lengths))
    probs, _ = models.apply(cfg, model, torch.from_numpy(wav), train=True,
                            lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(p_j), atol=1e-5, rtol=0)


def test_stochastic_parts_are_seeded_and_active(carried):
    """Dropout, attention dropout, drop-path and patch dropout: the same
    generator seed gives the same probs, another seed others, and the
    deterministic forward differs from both."""
    _, _, _, cfg, model = carried
    sto = dataclasses.replace(cfg, drop_rate=0.1, attn_drop_rate=0.1, drop_path_rate=0.2,
                              time_patch_out=0.3, freq_patch_out=0.25)
    wav = torch.from_numpy(_wav(9))

    def run(seed):
        return models.apply(sto, model, wav, train=True,
                            generator=torch.Generator().manual_seed(seed))[0]

    a, b, c = run(1), run(1), run(2)
    det = models.apply(cfg, model, wav, train=True)[0]
    assert torch.equal(a, b) and not torch.equal(a, c) and not torch.equal(a, det)
    assert torch.isfinite(a).all()
    with pytest.raises(ValueError, match="Generator"):
        models.apply(sto, model, wav, train=True)
    x = torch.arange(10.0).reshape(1, 1, 10, 1)
    kept = _drop_patches(torch.Generator().manual_seed(0), x, 2, 0.3).flatten()
    assert kept.numel() == 7 and torch.equal(kept, kept.sort().values)  # order kept
