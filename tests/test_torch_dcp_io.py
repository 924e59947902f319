"""The port's DCP checkpoint backend (uit_mobile_tpu_torch.ckpt.dcp_io)
against the JAX package's Orbax backend on the CPU: the same (params,
state, cfg, extra) contract, the same trees back (bitwise), and
``resolve_model`` accepting the directory as JAX's accepts an Orbax one."""

import jax
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_to_numpy
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.ckpt.dcp_io import is_dcp_dir, load_dcp, save_dcp

pytest.importorskip("orbax.checkpoint")
torch.set_num_threads(1)


def _flat(params, state):
    return {**{f"p/{k}": np.asarray(v) for k, v in flatten_tree(params, "/").items()},
            **{f"s/{k}": np.asarray(v) for k, v in flatten_tree(state, "/").items()}}


def test_dcp_round_trip(tmp_path):
    cfg = models.get_model_config("uit_xxxs", outputdim=17, target_length=102, depth=2)
    model = models.build(cfg, torch.Generator().manual_seed(0), "cpu")
    params, state = module_to_numpy(model)
    out = save_dcp(tmp_path / "ckpt", params, state, cfg,
                   extra={"step": 7, "run_config": {"basename": True}})
    assert is_dcp_dir(out) and not is_dcp_dir(tmp_path)
    p2, s2, cfg2, extra = load_dcp(tmp_path / "ckpt")
    assert cfg2 == cfg
    assert extra["step"] == 7 and extra["run_config"]["basename"] is True
    a, b = _flat(params, state), _flat(p2, s2)
    assert a.keys() == b.keys()
    assert all(np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype for k in a)
    # the restored trees drive the model identically
    from uit_mobile_tpu_torch.ckpt import module_from_numpy

    wav = torch.zeros(1, 16000)
    assert torch.equal(models.apply(cfg, model, wav),
                       models.apply(cfg2, module_from_numpy(cfg2, p2, s2, "cpu"), wav))
    # saving again replaces the directory
    save_dcp(tmp_path / "ckpt", params, state, None)
    assert load_dcp(tmp_path / "ckpt")[2] is None


def test_orbax_and_dcp_trees_load_equal(tmp_path):
    """The same JAX trees through JAX's Orbax save/load and the port's DCP
    save/load come back equal, key for key, bitwise."""
    from uit_mobile_tpu.ckpt.orbax_io import load_orbax, save_orbax

    jcfg = jax_models.get_model_config("uit_xxxs", outputdim=9, target_length=102, depth=1)
    params, state = jax.tree.map(np.asarray, jax_models.build(jcfg, jax.random.key(1)))
    save_orbax(tmp_path / "ob", params, state, jcfg, extra={"step": 3})
    save_dcp(tmp_path / "dcp", params, state, models.get_model_config(
        "uit_xxxs", outputdim=9, target_length=102, depth=1), extra={"step": 3})
    op, os_, _, oextra = load_orbax(tmp_path / "ob")
    dp, ds, dcfg, dextra = load_dcp(tmp_path / "dcp")
    o, d = _flat(op, os_), _flat(dp, ds)
    assert o.keys() == d.keys() and oextra == dextra
    assert all(np.array_equal(o[k], d[k]) for k in o)
    assert dcfg.outputdim == 9 and dcfg.depth == 1


def test_resolve_model_accepts_dcp_dir(tmp_path):
    from uit_mobile_tpu_torch.cli.common import resolve_model, resolve_params

    cfg = models.get_model_config("uit_xxxs", outputdim=9, target_length=102, depth=1)
    params, state = module_to_numpy(models.build(cfg, torch.Generator().manual_seed(1), "cpu"))
    save_dcp(tmp_path / "d", params, state, cfg, extra={"run_config": {"basename": True}})
    cfg2, model, extra = resolve_model(str(tmp_path / "d"), device="cpu", return_extra=True)
    assert cfg2 == cfg and extra["run_config"]["basename"] is True
    a, b = _flat(params, state), _flat(*module_to_numpy(model))
    assert all(np.array_equal(a[k], b[k]) for k in a)
    save_dcp(tmp_path / "nocfg", params, state, None)
    with pytest.raises(ValueError, match="no embedded config"):
        resolve_params(str(tmp_path / "nocfg"))
