"""SED (strong-label framewise) training in the port (data/hdf5.py's
StrongFramewiseHDF5Dataset, train/sed.py, ``cli.train sed``) against the
JAX package on the CPU (the framewise forward and step:
tests/test_torch_framewise_train.py).

Tolerances: the dataset's windows and targets bitwise; a best_sed.npz
written by the port gives the same framewise probabilities in both
packages within 1e-5.
"""

import random

import h5py
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.data import StrongFramewiseHDF5Dataset as JaxStrong
from uit_mobile_tpu.data import read_tsv_data as jax_read_tsv
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.data import StrongFramewiseHDF5Dataset, read_tsv_data

torch.set_num_threads(1)
SR = 16000


@pytest.fixture(scope="module")
def sed_env(tmp_path_factory):
    """The JAX test's world: a class tone burst in the first or second half
    of each 1 s clip over a noise floor, plus 3 s clips with events that
    straddle window edges."""
    tmp = tmp_path_factory.mktemp("sed")
    rng = np.random.default_rng(0)
    h5 = tmp / "sed.h5"
    rows = []
    with h5py.File(h5, "w") as f:
        for i in range(24):
            cls, half = i % 2, (i // 2) % 2
            clip = (rng.standard_normal(SR) * 120).astype(np.int16)
            t = np.arange(SR // 2) / SR
            tone = np.sin(2 * np.pi * (600 + 2400 * cls) * t) * 12000
            lo = half * (SR // 2)
            clip[lo:lo + SR // 2] += tone.astype(np.int16)
            f[f"c_{i}.wav"] = clip
            rows.append((f"c_{i}.wav", str(cls), str(h5), lo / SR, (lo + SR // 2) / SR))
        for i in range(4):
            f[f"long_{i}.wav"] = rng.integers(-300, 300, 3 * SR, np.int16)
            rows.append((f"long_{i}.wav", str(i % 3), str(h5), 0.5 + 0.3 * i, 2.5))
            rows.append((f"long_{i}.wav", "5", str(h5), 0.1, 0.9))
    tsv = tmp / "sed.tsv"
    pd.DataFrame(rows, columns=["filename", "labels", "hdf5path", "from", "to"]).to_csv(
        tsv, sep="\t", index=False)
    return tsv


@pytest.mark.parametrize("deterministic", [False, True])
def test_strong_dataset_matches_jax(sed_env, deterministic):
    kw = dict(num_classes=10, n_segments=6, seg_seconds=0.16, chunk_length=1.0,
              deterministic=deterministic)
    mine = StrongFramewiseHDF5Dataset(read_tsv_data(sed_env, basename=False),
                                      rng=random.Random(0), **kw)
    theirs = JaxStrong(jax_read_tsv(sed_env, basename=False), rng=random.Random(0), **kw)
    assert len(mine) == len(theirs) == 28  # one item per file
    order = list(range(28)) if not deterministic else [27, 3, 0, 26, 1, 25, 24]
    for i in order:
        (w1, t1, f1), (w2, t2, f2) = mine[i], theirs[i]
        assert f1 == f2 and np.array_equal(w1, w2) and np.array_equal(t1, t2)
        assert t1.shape == (6, 10) and w1.shape == (SR,)
    w, t, _ = mine[0]  # c_0: class 0 in [0, 0.5) s
    assert t[:3, 0].all() and not t[4:, 0].any() and t[:, 1:].sum() == 0
    if deterministic:  # index-pure: another rng, another read order, same windows
        other = StrongFramewiseHDF5Dataset(read_tsv_data(sed_env, basename=False),
                                           rng=random.Random(5), **kw)
        for i in (26, 24, 27):
            assert all(np.array_equal(a, b) for a, b in zip(other[i], mine[i]))


def _sed_config(tmp_path, sed_env, **kw):
    return dict(dict(
        outputpath=str(tmp_path / "exp"), config_stem="sed", model="uit_xxxs",
        model_args={"target_length": 102, "depth": 1}, num_classes=10,
        strong_train_data=str(sed_env), strong_eval_data=str(sed_env), basename=False,
        batch_size=8, eval_batch_size=16, epochs=2, epoch_length=2, warmup_iters=1,
        optimizer="AdamW", optimizer_args={"lr": 1e-3}, num_workers=1, seed=0,
        data_dtype="int16", ema_decay=0.9), **kw)


def test_sed_cli_trains_and_both_packages_load(tmp_path, sed_env, capsys):
    import yaml

    from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load_checkpoint
    from uit_mobile_tpu_torch.ckpt import load_model
    from uit_mobile_tpu_torch.cli.train import main as train_main

    path = tmp_path / "sed.yaml"
    path.write_text(yaml.safe_dump(_sed_config(tmp_path, sed_env)))
    assert train_main(["sed", str(path), "--device", "cpu"]) == 0
    best = tmp_path.joinpath(capsys.readouterr().out.strip().splitlines()[-1])
    assert best.name == "best_sed.npz" and (best.parent / "last.npz").exists()
    log = (best.parent / "train.log").read_text()
    assert "Epoch 2:" in log and "segF1 micro" in log
    cfg, model, extra = load_model(best, device="cpu")
    assert cfg.pooling == "dm" and extra["epoch"] in (1, 2)
    wav = (np.random.default_rng(3).standard_normal((2, SR)) * 0.1).astype(np.float32)
    got, _ = models.apply_framewise(cfg, model, torch.from_numpy(wav))
    p, s, jcfg, _ = jax_load_checkpoint(best)
    want, _ = jax_models.uit.forward_framewise(jcfg, p, s, jnp.asarray(wav))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_sed_refusals(tmp_path, sed_env):
    from uit_mobile_tpu_torch.train.sed import train_sed_from_config

    with pytest.raises(ValueError, match="time-preserving"):
        train_sed_from_config(_sed_config(tmp_path, sed_env, wavtransforms={"Shift": {}}),
                              device="cpu")
    with pytest.raises(ValueError, match="strong_train_data"):
        train_sed_from_config(_sed_config(tmp_path, sed_env, strong_train_data=None),
                              device="cpu")
    with pytest.raises(NotImplementedError, match="§A17"):
        train_sed_from_config(_sed_config(tmp_path, sed_env, multihost=True), device="cpu")
    with pytest.raises(ValueError, match="'dm' head"):
        train_sed_from_config(_sed_config(tmp_path, sed_env,
                                          model_args={"target_length": 102, "depth": 1,
                                                      "pooling": "mean"}), device="cpu")
    assert not (tmp_path / "exp").exists() or not any((tmp_path / "exp").rglob("*.npz"))


def test_sed_auto_resume_restarts_from_last(tmp_path, sed_env, monkeypatch):
    """auto_resume: a crash in epoch 2's validation restarts from epoch 1's
    last.npz in the same run directory, and the run completes."""
    from uit_mobile_tpu_torch.train import sed as sed_mod

    real, calls = sed_mod.segment_f1, {"n": 0}

    def flaky(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("injected crash")
        return real(*a, **kw)

    monkeypatch.setattr(sed_mod, "segment_f1", flaky)
    best = sed_mod.train_sed_from_config(_sed_config(tmp_path, sed_env, auto_resume=1),
                                         device="cpu")
    assert best.exists() and calls["n"] == 3
    log = (best.parent / "train.log").read_text()
    assert "SED resumed from" in log and "at epoch 2" in log
    runs = list((tmp_path / "exp").iterdir())
    assert len(runs) == 1  # one pinned run directory
