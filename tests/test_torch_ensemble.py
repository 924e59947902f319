"""Checkpoint ensembles and the rest of make_forward_fn in the port: a list
of models averages the member probabilities over one frontend run (within
1e-6 of the mean of the members' forwards, tests/test_ensemble.py:42) and
matches the JAX package's vmapped ensemble (1e-5); comma-joined specs in
cli.common.resolve_model; mismatched members and configs raise; non-UiT
configs (MobileNetV2) through 'tfb_to_bft' on the kernel path."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save
from uit_mobile_tpu.cli.common import resolve_model as jax_resolve_model
from uit_mobile_tpu.ops.pipeline import make_forward_fn as jax_make_forward_fn
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy
from uit_mobile_tpu_torch.cli.common import resolve_model
from uit_mobile_tpu_torch.ops import make_forward_fn, make_scanned_forward

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def members():
    cfg = models.get_model_config("uit_xxxs", outputdim=12, target_length=102, depth=2)
    return cfg, [models.build(cfg, torch.Generator().manual_seed(i), "cpu") for i in range(3)]


def _noise(shape, seed):
    return (np.random.default_rng(seed).standard_normal(shape) * 0.1).astype(np.float32)


@pytest.mark.parametrize("T", [16000, 48000])
@pytest.mark.parametrize("use_kernel, precision", [(False, "exact"), (True, "exact"),
                                                   (True, "fast")])
def test_ensemble_is_the_mean_of_its_members(members, T, use_kernel, precision):
    """One window and the long-clip crop path; the rfft frontend and the
    kernel path ('tfb' layout, the kernel's plain version here)."""
    cfg, ms = members
    wav = _noise((4, T), seed=T)
    got = make_forward_fn(cfg, ms, use_kernel=use_kernel, precision=precision)(wav)
    want = torch.stack([make_forward_fn(cfg, m, use_kernel=use_kernel,
                                        precision=precision)(wav) for m in ms]).mean(0)
    assert got.shape == (4, 12)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
    single = make_forward_fn(cfg, ms[:1], use_kernel=use_kernel, precision=precision)(wav)
    assert torch.equal(single, make_forward_fn(cfg, ms[0], use_kernel=use_kernel,
                                               precision=precision)(wav))


def test_ensemble_composes_with_scanned_dispatch(members):
    cfg, ms = members
    fn = make_forward_fn(cfg, ms, use_kernel=False)
    wav = _noise((2, 16000), seed=1)
    block = np.stack([wav, wav * 0.5])
    got = make_scanned_forward(fn)(torch.from_numpy(block))
    assert torch.equal(got[0], fn(wav)) and torch.equal(got[1], fn(wav * 0.5))


def test_mismatched_members_raise(members):
    cfg, ms = members
    deeper = models.get_model_config("uit_xxxs", outputdim=12, target_length=102, depth=3)
    with pytest.raises(ValueError, match="share one model config"):
        make_forward_fn(cfg, ms + [models.build(deeper, device="cpu")], use_kernel=False)
    with pytest.raises(ValueError, match="non-empty"):
        make_forward_fn(cfg, [], use_kernel=False)


@pytest.fixture(scope="module")
def npz_members(tmp_path_factory):
    """Three JAX-written checkpoints: two of one config, one deeper."""
    root = tmp_path_factory.mktemp("ens")
    paths = []
    for i, depth in enumerate((2, 2, 3)):
        jcfg = jax_models.get_model_config("uit_xxxs", outputdim=537, target_length=102,
                                           depth=depth)
        params, state = jax_models.build(jcfg, jax.random.key(i))
        paths.append(str(root / f"m{i}.npz"))
        jax_save(paths[-1], params, state, jcfg, extra={"run_config": {"basename": True}})
    return paths


def test_comma_spec_matches_jax_ensemble(npz_members):
    spec = ",".join(npz_members[:2])
    cfg, ms, extra = resolve_model(spec, device="cpu", return_extra=True)
    assert len(ms) == 2 and extra["ensemble"] == 2 and extra["run_config"] == {"basename": True}
    assert resolve_model(npz_members[0], device="cpu")[0] == cfg
    jcfg, params, state = jax_resolve_model(spec)
    wav = _noise((3, 24000), seed=2)
    want = np.asarray(jax_make_forward_fn(jcfg, params, state, use_pallas=False)(
        jnp.asarray(wav)))
    fn = make_forward_fn(cfg, ms, use_kernel=False)
    assert not fn.uses_kernel and fn.top_db_mode == "torch"
    np.testing.assert_allclose(fn(wav).numpy(), want, atol=1e-5, rtol=0)


def test_comma_spec_refusals(npz_members):
    with pytest.raises(ValueError, match=">=2"):
        resolve_model(npz_members[0] + ",", device="cpu")
    with pytest.raises(ValueError, match="share one model config"):
        resolve_model(",".join([npz_members[0], npz_members[2]]), device="cpu")
    with pytest.raises(FileNotFoundError, match="model.pt does not exist"):
        resolve_model(f"{npz_members[0]},model.pt", device="cpu")
    with pytest.raises(FileNotFoundError, match="never downloads"):
        resolve_model(f"{npz_members[0]},https://example.org/m.npz", device="cpu")


@pytest.mark.parametrize("precision", ["exact", "fast"])
def test_non_uit_config_matches_jax(precision):
    """MobileNetV2 through make_forward_fn: 'tfb_to_bft' on the kernel path
    (its plain version here) against the JAX policy with Pallas in
    interpret mode, and the rfft path."""
    jcfg = jax_models.get_model_config("MobileNetV2", outputdim=9)
    params, state = jax_models.build(jcfg, jax.random.key(3))
    cfg = models.get_model_config("MobileNetV2", outputdim=9)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    wav = _noise((2, 16000), seed=3)
    for use_kernel in (True, False):
        want = np.asarray(jax_make_forward_fn(jcfg, params, state, use_pallas=use_kernel,
                                              precision=precision)(jnp.asarray(wav)))
        fn = make_forward_fn(cfg, model, use_kernel=use_kernel, precision=precision)
        assert fn.uses_kernel == use_kernel
        np.testing.assert_allclose(fn(wav).numpy(), want, atol=1e-5, rtol=0)
