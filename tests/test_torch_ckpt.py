"""npz checkpoints cross between the packages: JAX-saved loads in the port with
the same forward, port-saved loads in JAX."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import (config_from_dict, config_to_dict, load_checkpoint,
                                       load_model, module_to_numpy, save_checkpoint)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def wav():
    return (np.random.default_rng(0).standard_normal((2, 16000)) * 0.1).astype(np.float32)


def test_jax_checkpoint_loads_in_port(tmp_path, wav):
    jcfg = jax_models.get_model_config("uit_xxxs", outputdim=537, target_length=102)
    params, state = jax_models.build(jcfg, jax.random.key(1))
    jax_save(tmp_path / "jax.npz", params, state, jcfg, extra={"step": 7})
    cfg, model, extra = load_model(tmp_path / "jax.npz", device="cpu")
    assert extra == {"step": 7}
    assert config_to_dict(cfg) == _jax_cfg_dict(jcfg)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def _jax_cfg_dict(cfg):
    from uit_mobile_tpu.ckpt.io import config_to_dict as jax_cfg_to_dict

    return jax_cfg_to_dict(cfg)


def test_port_checkpoint_loads_in_jax(tmp_path, wav):
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=102,
                                  eval_avg="max")
    model = models.build(cfg, torch.Generator().manual_seed(3), device="cpu")
    save_checkpoint(tmp_path / "port", model, cfg)  # .npz appended
    params, state, jcfg, extra = jax_load(tmp_path / "port.npz")
    assert jcfg.eval_avg == "max" and extra == {}
    want = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    got = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # and back through the port: bitwise the same numpy trees
    p2, s2, cfg2, _ = load_checkpoint(tmp_path / "port.npz")
    p1, s1 = module_to_numpy(model)
    assert cfg2 == cfg
    for a, b in zip(jax.tree.leaves((p1, s1)), jax.tree.leaves((p2, s2))):
        assert np.array_equal(a, b)


def test_config_round_trip_and_unported_kinds():
    cfg = models.get_model_config("uit_xs", outputdim=537, target_length=102)
    assert config_from_dict(config_to_dict(cfg)) == cfg
    teacher = models.get_model_config("MobileNetV2", outputdim=527)
    assert config_from_dict(config_to_dict(teacher)) == teacher
    # the MoE's config nests its base; neither package rebuilds it from a dict
    moe = config_to_dict(models.get_model_config("uit_xs_moe", outputdim=37))
    assert moe["base"]["outputdim"] == 37 and moe["__model_config__"] == "MoEUITConfig"
    with pytest.raises(NotImplementedError, match="cannot rebuild an MoEUITConfig"):
        config_from_dict(moe)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        config_from_dict({"__model_config__": "SomeOtherConfig"})
