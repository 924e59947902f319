"""The port's evaluation entry points on the CPU: ``cli.evaluate`` (all six
commands, --device cpu) against the port's Evaluator, whose parity with
the JAX Evaluator tests/test_torch_evaluate.py holds; ``cli.infer
--timestamps/--events`` (one checkpoint and a comma-joined ensemble)
against the JAX CLI on a 3 s clip made from the samples (same segments,
labels and events, probabilities within 1e-3 as printed); ``cli.train run``
(train, then GSC and AudioSet on the config's test splits); the refusals."""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from test_torch_evaluate import build_world
from uit_mobile_tpu_torch.cli.evaluate import main as eval_main
from uit_mobile_tpu_torch.evaluate import Evaluator

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SAMPLE = REPO / "samples" / "85b877b5_nohash_0.wav"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("cliworld"))


def _dict_line(out: str) -> dict:
    line = next(ln for ln in out.splitlines() if ln.startswith("{"))
    return ast.literal_eval(re.sub(r"np\.float64\(([^)]*)\)", r"\1", line))


@pytest.mark.parametrize("command, args, method, kw", [
    ("gsc", ["--sweep", "--batch-size", "4", "--tie-mode", "reference", "--scan", "2"],
     "gsc", dict(sweep=True, tie_mode="reference")),
    ("audioset", ["--batch-size", "4", "--dtype", "int16"], "audioset", {}),
    ("calibrate", ["--batch-size", "4", "--per-class"], "calibrate", dict(per_class=True)),
    ("strong", ["--batch-size", "4", "--sweep", "--psds", "--median-kernel", "3"], "strong",
     dict(sweep=(0.1, 0.2, 0.3, 0.5, 0.7, 0.9), psds={"alpha_st": 0.0, "alpha_ct": 0.0,
                                                     "e_max": 100.0}, median_kernel=3)),
])
def test_cli_evaluate_matches_the_evaluator(world, tmp_path, capsys, command, args, method,
                                            kw):
    data = {"gsc": ["--eval-data", world["gsc"]],
            "audioset": ["--audioset-eval-data", world["audioset"]],
            "calibrate": ["--eval-data", world["audioset"]],
            "strong": ["--eval-data", world["strong"]]}[command]
    ckpt = world["ckpt_strong" if command == "strong" else "ckpt"]
    assert eval_main([command, ckpt, *data, *args, "--device", "cpu"]) == 0
    printed = capsys.readouterr().out
    got = _dict_line(printed) if command != "calibrate" else ast.literal_eval(
        printed.splitlines()[0])
    ev = Evaluator(ckpt, batch_size=4, num_workers=0, device="cpu", report_dir=str(tmp_path))
    data_kw = ({"audioset_eval_data": world["audioset"]} if command == "audioset"
               else {"eval_data": world[command if command != "calibrate" else "audioset"]})
    want = getattr(ev, method)(**data_kw, **kw)
    capsys.readouterr()
    for k, v in got.items():
        if isinstance(v, dict):
            assert v == pytest.approx(want[k], abs=1e-12)
        else:
            assert v == pytest.approx(want[k], abs=1e-12), k
    if command == "strong":
        assert "  PSD-ROC: " in printed and "best thresholds" in printed


def test_cli_evaluate_all_and_test_sample(world, capsys):
    assert eval_main(["all", world["ckpt"], "--eval-data", world["gsc"],
                      "--audioset-eval-data", world["audioset"], "--batch-size", "4",
                      "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("{'Accuracy@0.2':") and "'mAP':" in out[1]
    assert eval_main(["test_sample", world["ckpt"], str(SAMPLE), "--device", "cpu"]) == 0
    got = capsys.readouterr().out.splitlines()
    from uit_mobile_tpu.evaluate import Evaluator as JaxEvaluator

    JaxEvaluator(world["ckpt"], use_pallas=False).test_sample(None, str(SAMPLE))
    want = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in got] == [ln.split(":")[0] for ln in want]
    for g, w in zip(got, want):
        assert abs(float(g.split(":")[1]) - float(w.split(":")[1])) <= 0.01 + 1e-9


def test_cli_evaluate_refusals(world):
    # --data-parallel is ported: one CPU device is the single-device path
    assert eval_main(["gsc", world["ckpt"], "--eval-data", world["gsc"], "--data-parallel",
                      "--device", "cpu"]) == 0
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            eval_main(["gsc", world["ckpt"]])


def _rows(out: str):
    """Printed framewise rows -> [(header) | (t0, t1, [(label, prob)]) |
    (t0, t1, label)]."""
    rows = []
    for line in out.splitlines():
        if line.startswith("====="):
            rows.append(line.strip("= ").strip())
            continue
        m = re.match(r"\[\s*([\d.]+)-\s*([\d.]+)s\] (.*)", line)
        if not m:
            rows.append(line)
            continue
        t0, t1, rest = float(m.group(1)), float(m.group(2)), m.group(3)
        parts = re.findall(r"(.+?) (\d\.\d{3})(?:  |$)", rest)
        rows.append((t0, t1, [(n.strip(), float(p)) for n, p in parts] if parts else rest))
    return rows


@pytest.fixture(scope="module")
def three_second_clip(tmp_path_factory):
    from uit_mobile_tpu_torch.data import read_wav, write_wav

    waves = [read_wav(p)[0][0] for p in sorted((REPO / "samples").glob("*.wav"))]
    clip = np.resize(np.concatenate(waves), 3 * 16000)
    path = tmp_path_factory.mktemp("clip") / "three.wav"
    write_wav(path, clip, sample_rate=16000)
    return str(path)


@pytest.mark.parametrize("flags", [["--timestamps"], ["--events", "--event-threshold", "0.5",
                                                      "--median-kernel", "3"]])
@pytest.mark.parametrize("ensemble", [False, True])
def test_cli_infer_framewise_matches_jax(world, three_second_clip, capsys, monkeypatch,
                                         flags, ensemble):
    from uit_mobile_tpu.cli.infer import main as jax_main
    from uit_mobile_tpu_torch.cli.infer import main as port_main

    monkeypatch.setenv("UIT_MOBILE_TPU_NO_COMPILE_CACHE", "1")
    spec = world["ckpt_strong"] if not ensemble else ",".join([world["ckpt_strong"]] * 2)
    args = [three_second_clip, "-m", spec, "-k", "3", *flags]
    assert jax_main(args) == 0
    want = _rows(capsys.readouterr().out)
    assert port_main([*args, "--device", "cpu"]) == 0
    got = _rows(capsys.readouterr().out)
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        if isinstance(w, tuple) and isinstance(w[2], list):
            assert g[:2] == w[:2] and [n for n, _ in g[2]] == [n for n, _ in w[2]]
            np.testing.assert_allclose([p for _, p in g[2]], [p for _, p in w[2]], atol=1e-3)
        else:
            assert g == w


def test_cli_train_run_evaluates_the_deliverable(tmp_path, capsys):
    """``run``: train, then GSC on kws_test_data and AudioSet on
    audioset_eval_data, reports beside the deliverable."""
    from uit_mobile_tpu_torch.cli.train import main as train_main
    from uit_mobile_tpu_torch.data.synthworld import build_world as synth_world
    import yaml

    cfg = dict(outputpath=str(tmp_path / "exp"), num_classes=537, model="uit_xxxs",
               model_args={"target_length": 102, "depth": 1}, batch_size=8, epochs=1,
               epoch_length=2, warmup_iters=1, chunk_length=1.0, optimizer="AdamW",
               optimizer_args={"lr": 1e-3}, early_stop=10, n_saved=1, num_workers=1,
               valid_every=1, seed=0, config_stem="run",
               **synth_world(tmp_path / "world", n_train=16, n_eval=8))
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_main(["run", str(path), "--device", "cpu"]) == 0
    out = Path(capsys.readouterr().out.strip().splitlines()[-1])
    assert out.name == "averaged.npz"
    gsc = (out.parent / "evaluation_GSC.txt").read_text().splitlines()
    audioset = (out.parent / "evaluation_Audioset.txt").read_text().splitlines()
    assert gsc[0] == "GSC Results" and gsc[1].startswith("Accuracy@0.2 : ")
    assert audioset[0] == "Audioset Results" and any(ln.startswith("mAP : ") for ln in audioset)
