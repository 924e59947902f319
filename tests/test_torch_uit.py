"""Port UiT model (uit_mobile_tpu_torch.models) vs the JAX package on the CPU:
JAX ``models.build(cfg, jax.random.key(0))`` parameters are carried into the
port with ``module_from_numpy`` and both forwards see the same numpy input.

Measured (CPU, uit_xxxs): bft forward drift <= 1.2e-7, btf/tfb kernel-path
drift <= 1.8e-7, e2e golden drift ~1e-7; held to 1e-5 (bft, golden) and 1e-4
(btf/tfb, where init_bn is folded into the patch embed)."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ops import make_forward_fn as jax_make_forward_fn
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy
from uit_mobile_tpu_torch.data import read_wav
from uit_mobile_tpu_torch.models.uit import _window_starts
from uit_mobile_tpu_torch.ops import make_forward_fn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
GOLDEN = Path(__file__).parent / "goldens" / "e2e_golden.npz"


def _carry(name="uit_xxxs", **kw):
    kw = dict(outputdim=537, target_length=102, **kw)
    jcfg = jax_models.get_model_config(name, **kw)
    params, state = jax_models.build(jcfg, jax.random.key(0))
    cfg = models.get_model_config(name, **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    return jcfg, params, state, cfg, model


@pytest.fixture(scope="module")
def carried():
    return _carry()


def _noise(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("T", [16000, 8000])
def test_bft_forward_matches_jax(carried, T):
    jcfg, params, state, cfg, model = carried
    wav = _noise((2, T), seed=T)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    assert got.shape == (2, 537)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("btf", [None, False])
def test_kernel_path_forward_matches_jax(carried, precision, btf):
    """make_forward_fn on the kernel path ('tfb', init_bn folded) and with the
    btf=False escape hatch, through both packages (Pallas in interpret mode)."""
    jcfg, params, state, cfg, model = carried
    wav = _noise((2, 16000), seed=11)
    want = np.asarray(jax_make_forward_fn(jcfg, params, state, use_pallas=True,
                                          precision=precision, btf=btf)(jnp.asarray(wav)))
    got = make_forward_fn(cfg, model, use_kernel=True, precision=precision,
                          btf=btf)(wav).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("layout", ["btf", "tfb"])
def test_folded_layouts_match_bft(carried, layout):
    """The btf/tfb patch embeds (init_bn folded) against the bft path."""
    from uit_mobile_tpu_torch.ops.mel import make_frontend_fn
    import dataclasses

    _, _, _, cfg, model = carried
    wav = torch.from_numpy(_noise((3, 48000), seed=12))
    want = models.apply(cfg, model, wav)
    run_cfg = dataclasses.replace(cfg, mel_layout=layout)
    got = models.apply(run_cfg, model, wav,
                       frontend_fn=make_frontend_fn(use_kernel=False, layout=layout))
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("eval_avg", ["mean", "max"])
def test_long_clip_crop_path_matches_jax(eval_avg):
    """3 s clip: three 102-frame windows, the tail replaced by the last full one."""
    jcfg, params, state, cfg, model = _carry(eval_avg=eval_avg)
    wav = _noise((1, 48000), seed=13)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert _window_starts(301, 102) == [0, 102, 199]


def test_e2e_golden(carried):
    """The committed JAX golden (uit_xxxs, key(0), GSC sample); measured drift
    ~1e-7 on the CPU."""
    _, _, _, cfg, model = carried
    wav, sr = read_wav(REPO / "samples" / "85b877b5_nohash_0.wav")
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    want = np.load(GOLDEN)["probs"]
    assert np.abs(got - want).max() <= 1e-5


def test_too_short_clip_raises(carried):
    _, _, _, cfg, model = carried
    with pytest.raises(ValueError, match="0.16s"):
        models.apply(cfg, model, torch.zeros(1, 2000))


def test_numpy_round_trip_is_exact(carried):
    jcfg, params, state, cfg, model = carried
    p2, s2 = module_to_numpy(module_from_numpy(cfg, *module_to_numpy(model), device="cpu"))
    p1, s1 = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    assert jax.tree.structure(p1) == jax.tree.structure(p2)
    assert jax.tree.structure(s1) == jax.tree.structure(s2)
    for a, b in zip(jax.tree.leaves((p1, s1)), jax.tree.leaves((p2, s2))):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_parameter_names_mirror_the_jax_tree(carried):
    _, _, _, _, model = carried
    names = dict(model.named_parameters())
    assert tuple(names["blocks.3.attn.qkv.kernel"].shape) == (128, 96)
    assert {k for k, _ in model.named_buffers()} == {"init_bn.mean", "init_bn.var"}
    with pytest.raises(KeyError, match="missing"):
        module_from_numpy(model.cfg, {"head": {"kernel": np.zeros((128, 537))}}, {},
                          device="cpu")


@pytest.mark.parametrize("pooling", ["token", "dm"])
def test_other_poolings_match_jax(pooling):
    jcfg, params, state, cfg, model = _carry(depth=1, pooling=pooling)
    wav = _noise((2, 16000), seed=14)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_length_mask_matches_jax():
    jcfg, params, state, cfg, model = _carry(depth=1, use_length_mask=True)
    wav = _noise((2, 16000), seed=15)
    wav[1, 8000:] = 0.0
    lengths = np.array([16000, 8000])
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav),
                                       lengths=jnp.asarray(lengths)))
    got = models.apply(cfg, model, torch.from_numpy(wav),
                       lengths=torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_build_defaults_to_cuda_and_train_is_deferred(carried):
    _, _, _, cfg, model = carried
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            models.build(cfg)
    # training and its bfloat16 compute are ported
    bf16 = dataclasses.replace(cfg, compute_dtype="bfloat16")
    probs, _ = models.apply(bf16, model, torch.zeros(1, 16000), train=True)
    assert probs.shape == (1, cfg.outputdim) and torch.isfinite(probs).all()
    # the MoE UiT is ported: it builds; an unknown name is the registry's KeyError
    moe_cfg = models.get_model_config("uit_xs_moe")
    assert isinstance(moe_cfg, models.MoEUITConfig)
    moe_model = models.build(moe_cfg, torch.Generator().manual_seed(0), "cpu")
    assert moe_model.blocks[0].moe.fc1.kernel.shape == (8, 128, 384)
    with pytest.raises(KeyError, match="unknown model"):
        models.get_model_config("uit_nonexistent")
