"""The port's MobileNetV2 (the PSL teacher) against the JAX package on the
CPU, at the default width on 1 s clips, with the JAX weights carried by
ckpt/convert.py (HWIO conv kernels -> OIHW).

Tolerances: eval probs 1e-5. In train mode each BN normalizes with
the batch's statistics, which amplifies float32 rounding through the 52
BNs: there the JAX package's float32 forward is 1.7e-5 from a float64
evaluation of the same forward and the port's 1.9e-6 (readings on the CPU
when this test was written, B=8). So the port's train forward is held to
its own float64 evaluation within 1e-5 and to JAX within 5e-5, probs and
BN state alike. The JAX -> port -> JAX weight carry is bitwise. Dropout is
off in the train parity (no generator / no key)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load_checkpoint
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import (config_from_dict, config_to_dict, load_model,
                                       module_from_numpy, module_to_numpy, save_checkpoint)
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.models.mobilenetv2 import layer_specs, total_time_stride

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def carried():
    jcfg = jax_models.get_model_config("MobileNetV2", outputdim=17)
    params, state = jax_models.build(jcfg, jax.random.key(1))
    cfg = models.get_model_config("MobileNetV2", outputdim=17)
    p_np, s_np = jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, state)
    return jcfg, params, state, cfg, module_from_numpy(cfg, p_np, s_np, device="cpu"), p_np, s_np


def _wav(B=3, T=16000, seed=0):
    return (np.random.default_rng(seed).standard_normal((B, T)) * 0.1).astype(np.float32)


def test_structure_matches_jax(carried):
    jcfg, _, _, cfg, model, p_np, _ = carried
    from uit_mobile_tpu.models.mobilenetv2 import layer_specs as jax_layer_specs

    assert layer_specs(cfg) == jax_layer_specs(jcfg)
    assert total_time_stride(cfg) == 32
    # depthwise convs as OIHW with one input channel per group
    assert tuple(model.features[2].layers[1].conv.kernel.shape) == (96, 1, 3, 3)
    assert p_np["features"][2]["layers"][1]["conv"]["kernel"].shape == (3, 3, 1, 96)


def test_weight_carry_round_trip_bitwise(carried, tmp_path):
    """JAX pytree -> port module -> JAX pytree, and through a port-written
    npz read by the JAX package's loader, bitwise."""
    _, _, _, cfg, model, p_np, s_np = carried
    params, state = module_to_numpy(model)
    for want, got in ((p_np, params), (s_np, state)):
        fw, fg = flatten_tree(want, "/"), flatten_tree(got, "/")
        assert fw.keys() == fg.keys()
        assert all(np.array_equal(fw[k], fg[k]) for k in fw)
    save_checkpoint(tmp_path / "teacher.npz", model, cfg)
    jp, js, jcfg2, _ = jax_load_checkpoint(tmp_path / "teacher.npz")
    assert type(jcfg2).__name__ == "MobileNetV2Config" and jcfg2.outputdim == 17
    fw, fg = flatten_tree(p_np, "/"), flatten_tree(jax.tree.map(np.asarray, jp), "/")
    assert all(np.array_equal(fw[k], fg[k]) for k in fw)
    cfg2, model2, _ = load_model(tmp_path / "teacher.npz", device="cpu")
    assert cfg2 == cfg and config_from_dict(config_to_dict(cfg)) == cfg
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                  model2.state_dict().values()))


@pytest.mark.parametrize("T", [16000, 24000])
def test_eval_forward_matches_jax(carried, T):
    jcfg, params, state, cfg, model, _, _ = carried
    wav = _wav(T=T, seed=T)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav))
    assert got.shape == (3, 17) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("mixup", [False, True])
def test_train_forward_matches_jax(carried, mixup):
    jcfg, params, state, cfg, model, p_np, s_np = carried
    wav = _wav(B=8, seed=3)
    lamb = np.random.default_rng(4).beta(0.3, 0.3, 8).astype(np.float32) if mixup else None
    p_j, s_j = jax_models.apply(jcfg, params, state, jnp.asarray(wav), train=True, rng=None,
                                mixup_lamb=None if lamb is None else jnp.asarray(lamb))
    probs, new_state = models.apply(cfg, model, torch.from_numpy(wav), train=True,
                                    mixup_lamb=None if lamb is None else torch.from_numpy(lamb))
    assert probs.requires_grad
    np.testing.assert_allclose(probs.detach().numpy(), np.asarray(p_j), atol=5e-5, rtol=0)
    m64 = module_from_numpy(cfg, p_np, s_np, device="cpu").double()
    p64, s64 = models.apply(cfg, m64, torch.from_numpy(wav).double(), train=True,
                            mixup_lamb=None if lamb is None else torch.from_numpy(lamb).double())
    torch.testing.assert_close(probs.double(), p64, atol=1e-5, rtol=0)
    want = flatten_tree(jax.tree.map(np.asarray, s_j), ".")
    assert set(new_state) == set(want) == set(s64)  # every BN moves, keyed by buffer name
    for k, v in want.items():
        np.testing.assert_allclose(new_state[k].numpy(), v, atol=5e-5, rtol=0)
        torch.testing.assert_close(new_state[k].double(), s64[k], atol=1e-5, rtol=0)
    # BN momentum 0.1: the first stem BN's running mean moved by 0.1 x batch mean
    assert not torch.equal(new_state["features.0.bn.mean"], model.features[0].bn.mean)


def test_train_dropout_seeded_and_guards(carried):
    _, _, _, cfg, model, _, _ = carried
    wav = torch.from_numpy(_wav(B=2, seed=5))

    def run(seed):
        return models.apply(cfg, model, wav, train=True,
                            generator=torch.Generator().manual_seed(seed))[0]

    assert torch.equal(run(1), run(1)) and not torch.equal(run(1), run(2))
    from uit_mobile_tpu_torch.augment import parse_wavtransforms

    with pytest.raises(ValueError, match="wav augments"):
        models.apply(cfg, model, (wav * 3000).to(torch.int16), train=True,
                     generator=torch.Generator(),
                     wav_augment=parse_wavtransforms({"Gain": {"p": 1.0}}))
    # bfloat16 compute runs (tests/test_torch_bf16.py holds it against JAX)
    bf16 = models.apply(dataclasses.replace(cfg, compute_dtype="bfloat16"), model, wav)
    assert torch.isfinite(bf16).all() and bf16.dtype == torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        dataclasses.replace(cfg, compute_dtype="float16")
