"""The port's Trainer and training CLI end to end on the CPU, on the tiny
h5 + tsv world of tests/test_train_loop.py: checkpoints, averaging, resume,
and a port-written averaged.npz that the JAX package loads and scores like
the port (eval probs within 1e-5)."""

import jax.numpy as jnp
import numpy as np
import pandas as pd
import h5py
import pytest
import torch
import yaml

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import load_checkpoint as jax_load_checkpoint
from uit_mobile_tpu_torch import models
from uit_mobile_tpu_torch.ckpt import load_model, load_training_state
from uit_mobile_tpu_torch.cli.train import main as train_main
from uit_mobile_tpu_torch.train import loop as loop_mod
from uit_mobile_tpu_torch.train import train_from_config

torch.set_num_threads(1)


@pytest.fixture()
def synth_env(tmp_path):
    """Two tiny datasets (AudioSet-like labels 0-526 and keywords 527-536)."""
    rng = np.random.default_rng(0)

    def make(name, n, label_pool, lengths=(12000, 17000)):
        h5 = tmp_path / f"{name}.h5"
        rows = []
        with h5py.File(h5, "w") as f:
            for i in range(n):
                L = int(rng.integers(*lengths))
                f[f"{name}_{i}.wav"] = (rng.standard_normal(L) * 3000).astype(np.int16)
                lab = ";".join(map(str, rng.choice(label_pool, size=2, replace=False)))
                rows.append((f"{name}_{i}.wav", lab, str(h5)))
        tsv = tmp_path / f"{name}.tsv"
        pd.DataFrame(rows, columns=["filename", "labels", "hdf5path"]).to_csv(
            tsv, sep="\t", index=False)
        return str(tsv)

    return dict(audioset_train_data=make("astrain", 16, np.arange(0, 527)),
                audioset_eval_data=make("aseval", 8, np.arange(0, 527)),
                kws_train_data=make("kwstrain", 16, np.arange(527, 537)),
                kws_test_data=make("kwseval", 8, np.arange(527, 537)))


def base_config(tmp_path, synth_env, **overrides):
    cfg = dict(outputpath=str(tmp_path / "exp"), num_classes=537, model="uit_xxxs",
               model_args={"target_length": 102, "depth": 1}, batch_size=8, epochs=2,
               epoch_length=2, warmup_iters=2, chunk_length=1.0, optimizer="AdamW",
               optimizer_args={"lr": 1e-3, "weight_decay": 1e-8}, early_stop=10, n_saved=2,
               num_workers=2, valid_every=1, seed=0, config_stem="smoke", **synth_env)
    cfg.update(overrides)
    return cfg


PSL = {"model": "MobileNetV2", "pretrained": "missing.npz", "allow_untrained": True}
AUGMENTS = dict(
    mixup=0.3, max_grad_norm=1.0,
    spectransforms=[{"TimeMasking": {"time_mask_param": 20}},
                    {"FrequencyMasking": {"freq_mask_param": 8}}],
    wavtransforms={"Shift": {"min_shift": -0.5, "max_shift": 0.5}, "Gain": {"p": 0.5},
                   "PolarityInversion": {"p": 0.5}})


def test_train_smoke_no_psl_and_jax_loads_the_deliverable(tmp_path, synth_env):
    out = train_from_config(base_config(tmp_path, synth_env), device="cpu")
    assert out.name == "averaged.npz" and out.exists()
    assert len(list(out.parent.glob("best_model_*_mAP=*.npz"))) == 2
    params, state, jcfg, extra = jax_load_checkpoint(out)
    assert jcfg.outputdim == 537 and len(extra["averaged_from"]) == 2
    cfg, model, _ = load_model(out, device="cpu")
    wav = (np.random.default_rng(1).standard_normal((3, 16000)) * 0.1).astype(np.float32)
    want = np.asarray(jax_models.apply(jcfg, params, state, jnp.asarray(wav)))
    got = models.apply(cfg, model, torch.from_numpy(wav)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    log = (out.parent / "train.log").read_text()
    assert "Validation Results - Epoch : 2" in log and "Averaged model mAP" in log


@pytest.mark.parametrize("extra", [
    dict(psl=PSL, **AUGMENTS),
    dict(psl=PSL, model_args={"target_length": 102, "depth": 1, "mel_layout": "tfb"},
         frontend_precision="fast", data_dtype="int16", mixup=0.3),
    dict(ema_decay=0.9, grad_accum=2, steps_per_dispatch=2, epoch_length=4),
])
def test_train_smoke_variants(tmp_path, synth_env, extra):
    """PSL with mixup, augments and clipping; the frontier's tfb/fast/int16
    layout with the teacher through 'tfb_to_bft'; EMA, gradient
    accumulation and multi-step groups."""
    out = train_from_config(base_config(tmp_path, synth_env, epochs=1, **extra), device="cpu")
    assert out.exists()
    loss_lines = [ln for ln in (out.parent / "train.log").read_text().splitlines()
                  if "Epoch 1" in ln and "loss" in ln]
    assert loss_lines and np.isfinite(float(loss_lines[0].split("loss")[1].split()[0]))


def test_pretrained_partial_load_and_averaging(tmp_path, synth_env):
    """pretrained: copies every parameter whose key and shape match (a
    depth-1 checkpoint into a depth-2 student: block 0 and the rest, not
    block 1); average_checkpoints is the element-wise mean."""
    from uit_mobile_tpu_torch.ckpt import (average_checkpoints, load_checkpoint,
                                           load_pretrained_partial, save_checkpoint)

    out = train_from_config(base_config(tmp_path, synth_env, epochs=1), device="cpu")
    params, _, _, _ = load_checkpoint(out)
    cfg2 = models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=2)
    student = models.build(cfg2, device="cpu")
    fresh_block1 = student.blocks[1].mlp.fc1.kernel.detach().clone()
    n = load_pretrained_partial(student, params)
    assert n == sum(1 for _ in models.build(
        models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=1),
        device="cpu").parameters())
    assert np.array_equal(student.blocks[0].mlp.fc1.kernel.detach().numpy(),
                          params["blocks"][0]["mlp"]["fc1"]["kernel"])
    assert torch.equal(student.blocks[1].mlp.fc1.kernel, fresh_block1)
    a, b = models.build(cfg2, torch.Generator().manual_seed(1), "cpu"), student
    save_checkpoint(tmp_path / "a.npz", a, cfg2)
    save_checkpoint(tmp_path / "b.npz", b, cfg2)
    avg_p, avg_s, avg_cfg, _ = average_checkpoints([tmp_path / "a.npz", tmp_path / "b.npz"])
    assert avg_cfg == cfg2
    np.testing.assert_allclose(avg_p["head"]["kernel"],
                               (a.head.kernel + b.head.kernel).detach().numpy() / 2, rtol=1e-6)
    run = train_from_config(base_config(tmp_path, synth_env, epochs=1, pretrained=str(out),
                                        model_args={"target_length": 102, "depth": 2}),
                            device="cpu")
    assert f"Loading {n} parameter tensors" in (run.parent / "train.log").read_text()


def test_resume_auto_from_last_npz(tmp_path, synth_env):
    run_dir = tmp_path / "pinned"
    cfg = base_config(tmp_path, synth_env, epochs=1, outputdir=str(run_dir))
    train_from_config(cfg, device="cpu")
    first = np.load(run_dir / "last.npz")
    assert first["opt/0"].tolist() == [2, 0]  # two applied updates, nothing accumulated
    out = train_from_config(dict(cfg, epochs=2, resume="auto"), device="cpu")
    assert "resumed from" in (run_dir / "train.log").read_text()
    cfg_m = models.get_model_config("uit_xxxs", outputdim=537, target_length=102, depth=1)
    model = models.build(cfg_m, device="cpu")
    from uit_mobile_tpu_torch.train import build_optimizer

    opt = build_optimizer("AdamW", 1e-3, weight_decay=1e-8).init(model)
    _, extra = load_training_state(run_dir / "last.npz", model, opt)
    assert extra["epoch"] == 2 and extra["step"] == 4 and opt.count == 4
    assert out.exists()


def test_auto_resume_restarts_from_snapshot(tmp_path, synth_env, monkeypatch):
    real_validate = loop_mod.Trainer._validate
    calls = {"n": 0}

    def flaky_validate(self, *a, **kw):
        calls["n"] += 1
        if calls["n"] == 2:  # the epoch-2 validation of the first attempt
            raise RuntimeError("injected crash")
        return real_validate(self, *a, **kw)

    monkeypatch.setattr(loop_mod.Trainer, "_validate", flaky_validate)
    out = train_from_config(base_config(tmp_path, synth_env, auto_resume=1), device="cpu")
    assert out.exists() and calls["n"] >= 3
    runs = list((tmp_path / "exp" / "smoke" / "uit_xxxs").iterdir())
    assert len(runs) == 1 and (runs[0] / "last.npz").exists()


def test_train_cli_yaml(tmp_path, synth_env, capsys):
    cfg_path = tmp_path / "cfg.yaml"
    cfg_path.write_text(yaml.safe_dump(base_config(tmp_path, synth_env, epochs=2)))
    assert train_main(["train", str(cfg_path), "--epochs", "1", "--device", "cpu"]) == 0
    assert capsys.readouterr().out.strip().endswith("averaged.npz")
    if not torch.cuda.is_available():  # the card by default: no GPU raises
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            train_main(["train", str(cfg_path), "--epochs", "1"])
    # pretrain and sed are ported (tests/test_torch_pretrain.py, test_torch_sed.py); a
    # weak-label config lacks the data they read
    for cmd, key in (("pretrain", "train_data"), ("sed", "strong_train_data")):
        with pytest.raises(ValueError, match=f"needs {key}"):
            train_main([cmd, str(cfg_path), "--device", "cpu"])


def test_in_memory_trainer_needs_no_h5py_pandas_yaml_sklearn(tmp_path):
    """The card's machine has none of h5py, pandas, PyYAML, scikit-learn:
    every port module imports without them, and chip_smoke.py's in-memory
    Trainer (its train phase, cut to uit_xxxs on the CPU) trains, validates
    and averages without them, with the online teacher and with psl:
    {mode: offline} over an in-memory cache and manifest."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parent.parent
    code = f"""
import sys
for name in ("jax", "jaxlib", "uit_mobile_tpu", "h5py", "pandas", "yaml", "sklearn"):
    sys.modules[name] = None
import importlib, pkgutil
import uit_mobile_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, "uit_mobile_tpu_torch."):
    importlib.import_module(m.name)
import chip_smoke
cfg = dict(chip_smoke.RECIPE, model="uit_xxxs", model_args={{"target_length": 102, "depth": 1}},
           batch_size=8, epochs=1, epoch_length=2, valid_every=1, outputdir={str(tmp_path)!r})
trainer = chip_smoke.synth_trainer_class()(cfg, device="cpu")
out = trainer.train()
assert out.name == "averaged.npz" and len(trainer.metrics) == 2, out
import numpy as np
from uit_mobile_tpu_torch.data.psl_cache import score_psl_cache
from uit_mobile_tpu_torch.data.synthworld import eventful_labels, synth_eventful_clip
rng = np.random.default_rng(0)
clips = [(f"as_{{i}}.wav", synth_eventful_clip(rng, eventful_labels(rng), seconds=1.0 + i % 2))
         for i in range(8)]
cache = score_psl_cache(clips, lambda b: np.tile(np.abs(b).mean(1, keepdims=True) / 32768,
                                                 (1, 527)), batch_size=16)
store = dict(clips)
rows = [{{"filename": k, "labels": [0], "hdf5path": store}} for k, _ in clips]
off = chip_smoke.synth_trainer_class()(dict(cfg, psl={{"mode": "offline", "cache": cache}},
                                            audioset_train_data=rows,
                                            outputdir={str(tmp_path / "offline")!r}),
                                       device="cpu")
out = off.train()
assert off.psl_model is None and len(off.metrics) == 2, out
print("ok")
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")


def test_trainer_refusals(tmp_path, synth_env):
    with pytest.raises(ValueError, match="frontend_precision"):
        train_from_config(base_config(tmp_path, synth_env, frontend_precision="speedy"),
                          device="cpu")
    # offline PSL is ported (tests/test_torch_psl_offline.py); it needs a cache
    with pytest.raises(ValueError, match="offline.*needs cache"):
        train_from_config(base_config(tmp_path, synth_env, psl={"model": "MobileNetV2",
                                                                  "mode": "offline"}),
                          device="cpu")
    with pytest.raises(FileNotFoundError, match="PSL cache"):
        train_from_config(base_config(tmp_path, synth_env, psl={
            "mode": "offline", "cache": str(tmp_path / "nope.h5")}), device="cpu")
    with pytest.raises(NotImplementedError, match="multi-host"):
        train_from_config(base_config(tmp_path, synth_env, multihost=True), device="cpu")
    with pytest.raises(FileNotFoundError):  # a missing teacher without allow_untrained
        train_from_config(base_config(tmp_path, synth_env,
                                      psl={"model": "MobileNetV2", "pretrained": "x.npz"}),
                          device="cpu")
