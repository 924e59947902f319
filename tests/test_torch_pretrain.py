"""MAE pretraining in the port (train/pretrain.py, ``cli.train pretrain``)
and the Trainer's ``pretrained:`` load with the pos-embed retarget, against
the JAX package on the CPU.

The mask is drawn once by JAX (``jax.random.uniform(key, (B, L))``, the
draw of the JAX forward) and the same array is the port's ``noise``.
Tolerances: the MAE loss 1e-5 relative; each gradient within 1e-5 of the
JAX one relative to that tensor's largest; a pretrained load (MAE snapshot
at another target length, or a 1012-frame checkpoint into a 102 student)
gives the same parameters as the JAX Trainer within 1e-6.
"""

import dataclasses

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.train import pretrain as jax_mae
from uit_mobile_tpu.train.loop import Trainer as JaxTrainer
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import module_from_numpy, module_to_numpy, save_checkpoint
from uit_mobile_tpu_torch.ckpt.convert import flatten_tree, load_numpy
from uit_mobile_tpu_torch.train import pretrain as mae
from uit_mobile_tpu_torch.train.loop import Trainer

torch.set_num_threads(1)


def _mae_cfgs(**kw):
    kw = dict(outputdim=537, target_length=160, depth=1, **kw)
    enc_j = jax_models.get_model_config("uit_xxxs", **kw)
    enc = models.get_model_config("uit_xxxs", **kw)
    return (jax_mae.MAEConfig(encoder=enc_j, mask_ratio=0.75, decoder_depth=1),
            mae.MAEConfig(encoder=enc, mask_ratio=0.75, decoder_depth=1))


def _carry(jcfg, cfg, seed=0):
    params, state = jax_mae.init(jcfg, jax.random.key(seed))
    model = load_numpy(mae.MAE(cfg), jax.tree.map(np.asarray, params),
                       jax.tree.map(np.asarray, state))
    return params, state, model


def _wav(seed, B=2):
    return (np.random.default_rng(seed).standard_normal((B, 160 * 160)) * 0.1).astype(np.float32)


def test_mae_forward_and_grads_match_jax():
    jcfg, cfg = _mae_cfgs()
    params, state, model = _carry(jcfg, cfg)
    wav, key = _wav(0), jax.random.key(1)
    B, L = 2, jcfg.num_patches
    noise = np.array(jax.random.uniform(key, (B, L)))

    def loss_of(p):
        loss, new_state, aux = jax_mae.forward(jcfg, p, state, jnp.asarray(wav), key)
        return loss, (new_state, aux)

    (want, (want_state, aux)), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(
        params)
    loss, new_state, got_aux = mae.forward(cfg, model, torch.from_numpy(wav),
                                           noise=torch.from_numpy(noise))
    assert loss.item() == pytest.approx(float(want), rel=1e-5)
    np.testing.assert_array_equal(got_aux["mask"].numpy(), np.asarray(aux["mask"]))
    assert 0.6 < got_aux["mask"].mean().item() < 0.9
    np.testing.assert_allclose(new_state["init_bn.var"].numpy(),
                               np.asarray(want_state["init_bn"]["var"]), rtol=1e-5)
    names = [n for n, _ in model.named_parameters()]
    mine = dict(zip(names, torch.autograd.grad(loss, list(model.parameters()),
                                               materialize_grads=True)))
    want_g = flatten_tree(jax.tree.map(np.asarray, grads), ".")
    assert set(mine) == set(want_g)
    for k, g in mine.items():
        scale = max(np.abs(want_g[k]).max(), 1e-30)
        assert np.abs(g.numpy() - want_g[k]).max() <= 1e-5 * scale, k
    assert not mine["head.kernel"].any()  # the MAE loss leaves the head alone
    assert mine["blocks.0.mlp.fc1.kernel"].abs().sum() > 0
    assert mine["mae.decoder_blocks.0.mlp.fc1.kernel"].abs().sum() > 0


def test_mae_without_init_bn_matches_jax():
    jcfg, cfg = _mae_cfgs(init_bn=False)
    params, state, model = _carry(jcfg, cfg, seed=3)
    assert "init_bn" not in params and not hasattr(model, "init_bn")
    wav, key = _wav(1), jax.random.key(4)
    want, want_state, _ = jax_mae.forward(jcfg, params, state, jnp.asarray(wav), key)
    noise = np.array(jax.random.uniform(key, (2, jcfg.num_patches)))
    loss, new_state, _ = mae.forward(cfg, model, torch.from_numpy(wav),
                                     noise=torch.from_numpy(noise))
    assert new_state == {} and want_state == state
    assert loss.item() == pytest.approx(float(want), rel=1e-5)


def _unlabeled(tmp_path, n=8, samples=40000):
    rng = np.random.default_rng(0)
    h5 = tmp_path / "unlab.h5"
    rows = []
    with h5py.File(h5, "w") as f:
        for i in range(n):
            f[f"u{i}.wav"] = (rng.standard_normal(samples) * 3000).astype(np.int16)
            rows.append((f"u{i}.wav", "0", str(h5)))
    tsv = tmp_path / "unlab.tsv"
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
        tsv, sep="\t", index=False)
    return tsv


def _params_equal(a, b, atol=1e-6):
    fa, fb = flatten_tree(a, "."), flatten_tree(b, ".")
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_allclose(np.asarray(fa[k]), np.asarray(fb[k]), atol=atol, rtol=0,
                                   err_msg=k)


def _finetune_both(pretrained, seed=0, depth=1):
    """(port params, JAX params) of a 102-frame student built by each
    Trainer's _build_model from ``pretrained``."""
    config = {"model": "uit_xxxs", "num_classes": 537, "seed": seed,
              "model_args": {"target_length": 102, "depth": depth},
              "pretrained": str(pretrained)}
    t = Trainer.__new__(Trainer)  # no output directory
    t.config, t.device = config, torch.device("cpu")
    _, model = t._build_model()
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.config = config
    _, jparams, _ = JaxTrainer._build_model(jt)
    return module_to_numpy(model)[0], jax.tree.map(np.asarray, jparams)


def test_pretrained_retargets_pos_embeds_like_jax(tmp_path):
    """A 1012-frame checkpoint into a 102-frame student: the time pos
    embeds are sliced to the student's 6 patches, as the JAX Trainer does
    (before the retarget the port kept its random ones)."""
    cfg = models.get_model_config("uit_xxxs", outputdim=537, target_length=1012, depth=1)
    src = models.build(cfg, torch.Generator().manual_seed(9), device="cpu")
    save_checkpoint(tmp_path / "long.npz", src, cfg)
    mine, theirs = _finetune_both(tmp_path / "long.npz")
    assert mine["time_pos_embed"].shape == (6, 128)
    np.testing.assert_array_equal(mine["time_pos_embed"],
                                  src.time_pos_embed[:6].detach().numpy())
    _params_equal(mine, theirs)


def test_pretrain_cli_then_finetune_equals_jax(tmp_path, capsys):
    import yaml

    from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load_checkpoint
    from uit_mobile_tpu_torch.cli.train import main as train_main

    config = dict(outputpath=str(tmp_path / "exp"), train_data=str(_unlabeled(tmp_path)),
                  model="uit_xxxs", model_args={"target_length": 160, "depth": 1},
                  mask_ratio=0.75, decoder_depth=1, batch_size=4, epochs=1, epoch_length=2,
                  warmup_iters=1, optimizer_args={"lr": 1e-4}, num_workers=1, seed=0,
                  num_classes=537, ema_decay=0.9)
    path = tmp_path / "mae.yaml"
    path.write_text(yaml.safe_dump(config))
    assert train_main(["pretrain", str(path), "--device", "cpu"]) == 0
    out = tmp_path.joinpath(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.name == "mae_pretrained.npz" and (out.parent / "last.npz").exists()
    p, _, jcfg, extra = jax_load_checkpoint(out)  # the JAX package reads the snapshot
    assert extra["mae"] and jcfg.target_length == 160 and "mae" in p
    mine, theirs = _finetune_both(out)  # 160 -> 102: the time pos embeds retarget
    assert mine["time_pos_embed"].shape == (6, 128)
    _params_equal(mine, theirs)


def test_pretrain_auto_resume_and_refusals(tmp_path, monkeypatch):
    tsv = _unlabeled(tmp_path, n=6, samples=30000)
    base = dict(outputpath=str(tmp_path / "exp"), train_data=str(tsv), model="uit_xxxs",
                model_args={"target_length": 160, "depth": 1}, mask_ratio=0.75,
                decoder_depth=1, batch_size=2, epochs=2, epoch_length=1, warmup_iters=1,
                optimizer_args={"lr": 1e-4}, num_workers=1, seed=0)
    real, calls = mae.save_checkpoint, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return real(*a, **kw)

    monkeypatch.setattr(mae, "save_checkpoint", flaky)
    out = mae.pretrain_from_config(dict(base, auto_resume=1), device="cpu")
    assert out.exists() and calls["n"] >= 3
    with pytest.raises(ValueError, match="bft"):
        mae.pretrain_from_config(dict(base, model_args={"mel_layout": "tfb"}), device="cpu")
    with pytest.raises(ValueError, match="train_data"):
        mae.pretrain_from_config(dict(base, train_data=None), device="cpu")
    with pytest.raises(ValueError, match="noise= or a torch.Generator"):
        _, cfg = _mae_cfgs()
        mae.forward(cfg, mae.init(cfg, torch.Generator()), torch.zeros(1, 25600))
    assert dataclasses.replace(_mae_cfgs()[1], mask_ratio=0.99).num_keep == 1


def test_encode_window_matches_jax_and_the_forward():
    """encode_window: init_bn with its running statistics, features, head."""
    from uit_mobile_tpu.frontend import log_mel_spectrogram as jax_log_mel
    from uit_mobile_tpu_torch.frontend import log_mel_spectrogram
    from uit_mobile_tpu_torch.models import uit as uit_model

    kw = dict(outputdim=21, target_length=102, depth=1)
    jcfg = jax_models.get_model_config("uit_xxxs", **kw)
    params, state = jax_models.build(jcfg, jax.random.key(5))
    cfg = models.get_model_config("uit_xxxs", **kw)
    model = module_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              jax.tree.map(np.asarray, state), device="cpu")
    wav = _wav(6, B=3)[:, :16000]
    mel = log_mel_spectrogram(torch.from_numpy(wav), cfg.frontend)
    with torch.no_grad():
        got = uit_model.encode_window(cfg, model, mel)
    want = jax_models.uit.encode_window(jcfg, params, state,
                                        jax_log_mel(jnp.asarray(wav), jcfg.frontend))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(),
                               models.apply(cfg, model, torch.from_numpy(wav)).numpy(),
                               atol=1e-6, rtol=0)
