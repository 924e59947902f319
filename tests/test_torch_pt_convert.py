"""Reference ``.pt`` checkpoints in the port (ckpt/torch_convert.py,
cli/common.py) against the JAX package's converter on the CPU.

The state_dicts are built here from seeded weights (no published dump is in
the repository). The converters must give equal arrays, leaf for leaf, in
both directions; a ``.pt`` resolved by ``resolve_model`` must give the same
probabilities as the npz of the same weights, within 1e-6.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.cli import common as jax_common
from uit_mobile_tpu.ckpt import torch_convert as jax_tc
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_to_numpy, save_checkpoint
from uit_mobile_tpu_torch.ckpt import torch_convert as tc
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree
from uit_mobile_tpu_torch.cli import common

torch.set_num_threads(1)
KW = dict(outputdim=21, target_length=102, depth=2)


class MethodConfig:
    """A trainer dump's config wrapper whose ``.dict`` is a method."""

    def dict(self):
        return {"model": "uit_xxxs", "num_classes": 21,
                "model_args": {"depth": 2, "target_length": 102}}


class MappingConfig:
    """The reference's DictWrapper: ``.dict`` is a mapping attribute."""

    def __init__(self):
        self.dict = MethodConfig().dict()


def _equal_trees(a, b):
    fa, fb = flatten_tree(a, "/"), flatten_tree(b, "/")
    assert fa.keys() == fb.keys()
    for k in fa:
        assert np.array_equal(np.asarray(fa[k]), np.asarray(fb[k])), k


@pytest.fixture(scope="module")
def uit_sd():
    """A seeded port UiT and its reference-named torch state_dict."""
    cfg = models.get_model_config("uit_xxxs", **KW)
    model = models.build(cfg, torch.Generator().manual_seed(3), device="cpu")
    with torch.no_grad():  # non-trivial BN statistics
        model.init_bn.mean.normal_(0.0, 5.0, generator=torch.Generator().manual_seed(4))
        model.init_bn.var.uniform_(10.0, 40.0, generator=torch.Generator().manual_seed(5))
    params, state = module_to_numpy(model)
    return cfg, model, tc.uit_torch_state_dict_from_params(params, state, cfg)


@pytest.mark.parametrize("target_length", [102, 60, 170])
def test_uit_converter_matches_jax(uit_sd, target_length):
    """state_dict -> trees equal to the JAX converter's, also where the
    pos embeds are retargeted (slice to shrink, bilinear to grow)."""
    cfg, _, sd = uit_sd
    cfg_t = dataclasses.replace(cfg, target_length=target_length)
    jcfg = jax_models.get_model_config("uit_xxxs", **dict(KW, target_length=target_length))
    got = tc.uit_params_from_torch_state_dict(sd, cfg_t)
    want = jax.tree.map(np.asarray, jax_tc.uit_params_from_torch_state_dict(sd, jcfg))
    _equal_trees(got[0], want[0])
    _equal_trees(got[1], want[1])


def test_uit_round_trip_both_ways(uit_sd):
    cfg, model, sd = uit_sd
    params, state = module_to_numpy(model)
    jcfg = jax_models.get_model_config("uit_xxxs", **KW)
    want = jax_tc.uit_torch_state_dict_from_params(params, state, jcfg)
    assert sd.keys() == want.keys()
    for k in sd:
        assert np.array_equal(sd[k], want[k]), k
    back = tc.uit_params_from_torch_state_dict(sd, cfg)
    _equal_trees(back[0], params)
    _equal_trees(back[1], state)


def test_resize_pos_embed_matches_jax():
    emb = np.random.default_rng(0).standard_normal((6, 8)).astype(np.float32)
    for n in (3, 6, 7, 63):
        np.testing.assert_array_equal(tc.resize_pos_embed(emb, n),
                                      jax_tc.resize_pos_embed(emb, n))


def test_mobilenetv2_converter_matches_jax():
    cfg = models.get_model_config("MobileNetV2", outputdim=11, width_mult=0.25)
    jcfg = jax_models.get_model_config("MobileNetV2", outputdim=11, width_mult=0.25)
    model = models.build(cfg, torch.Generator().manual_seed(6), device="cpu")
    params, state = module_to_numpy(model)
    sd = tc.mobilenetv2_torch_state_dict_from_params(params, state, cfg)
    want_sd = jax_tc.mobilenetv2_torch_state_dict_from_params(params, state, jcfg)
    assert sd.keys() == want_sd.keys()
    for k in sd:
        assert np.array_equal(sd[k], want_sd[k]), k
    got = tc.mobilenetv2_params_from_torch_state_dict(sd, cfg)
    want = jax.tree.map(np.asarray, jax_tc.mobilenetv2_params_from_torch_state_dict(sd, jcfg))
    _equal_trees(got[0], want[0])
    _equal_trees(got[1], want[1])
    _equal_trees(got[0], params)


def _probs(cfg, model, seed=0):
    wav = np.random.default_rng(seed).standard_normal((3, 16000)).astype(np.float32) * 0.1
    return models.apply(cfg, model, torch.from_numpy(wav)).numpy()


@pytest.mark.parametrize("dump", ["raw", "method_config", "mapping_config"])
def test_pt_spec_resolves_like_the_npz(uit_sd, tmp_path, dump):
    cfg, model, sd = uit_sd
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    obj = {"raw": tensors,
           "method_config": {"model": tensors, "config": MethodConfig()},
           "mapping_config": {"model": tensors, "config": MappingConfig()}}[dump]
    pt = tmp_path / "model.pt"
    torch.save(obj, pt)
    npz = tmp_path / "model.npz"
    save_checkpoint(npz, model, cfg)
    got_cfg, got_model, extra = common.resolve_model(str(pt), device="cpu",
                                                     return_extra=True)
    assert got_cfg == cfg
    np.testing.assert_allclose(_probs(got_cfg, got_model),
                               _probs(*common.resolve_model(str(npz), device="cpu")),
                               atol=1e-6, rtol=0)
    # the JAX package reads the same dump to the same arrays and config
    mine, theirs = tc.load_torch_checkpoint(pt), jax_tc.load_torch_checkpoint(pt)
    assert mine["config"] == theirs["config"]
    assert (extra.get("run_config") is not None) == (dump != "raw")
    for k in mine["state_dict"]:
        assert np.array_equal(mine["state_dict"][k], theirs["state_dict"][k])


def test_inferred_config_matches_jax(uit_sd):
    _, _, sd = uit_sd
    got = common.infer_uit_config_from_state_dict(sd, act="relu", num_heads=2)
    want = jax_common.infer_uit_config_from_state_dict(sd, act="relu", num_heads=2)
    strip = lambda c: {k: v for k, v in dataclasses.asdict(c).items()  # noqa: E731
                       if k != "frontend"}
    assert strip(got) == strip(want)


def test_pt_in_directories_names_and_urls(uit_sd, tmp_path, monkeypatch):
    """An experiment directory holding only a .pt, a pretrained name with a
    ``checkpoints/<name>*.pt``, and a URL whose file lies in checkpoints/
    resolve through the converter; nothing is downloaded."""
    cfg, model, sd = uit_sd
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
    run = tmp_path / "run"
    run.mkdir()
    torch.save(tensors, run / "best_model_mAP=0.5.pt")
    want = _probs(cfg, model)
    np.testing.assert_allclose(_probs(*common.resolve_model(str(run), device="cpu")), want,
                               atol=1e-6, rtol=0)
    monkeypatch.setattr(common, "REPO_ROOT", tmp_path)
    (tmp_path / "checkpoints").mkdir()
    torch.save(tensors, tmp_path / "checkpoints" / "uit_xxxs_dump.pt")
    if not models.PRETRAINED_CHECKPOINTS["uit_xxxs"]["path"].exists():
        np.testing.assert_allclose(_probs(*common.resolve_model("uit_xxxs", device="cpu")),
                                   want, atol=1e-6, rtol=0)
    url = "https://zenodo.org/record/1/files/uit_xxxs_dump.pt?download=1"
    np.testing.assert_allclose(_probs(*common.resolve_model(url, device="cpu")), want,
                               atol=1e-6, rtol=0)
    with pytest.raises(FileNotFoundError, match="never downloads"):
        common.resolve_model("https://zenodo.org/record/1/files/absent.pt", device="cpu")
