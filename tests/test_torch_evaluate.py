"""The port's Evaluator against the JAX package's (both on the CPU, the JAX
one with use_pallas=False, the port's with the rfft frontend) on one tiny
h5 + tsv world and one JAX-written checkpoint: audioset, gsc (sweep,
detailed, both tie modes, pad, dump_predictions), calibrate, strong
(sweep, PSDS with cross triggers, thresholds_out, dump_events) and
test_sample. Probabilities within 1e-5, metrics within 1e-6, report files
with the same lines. Also: int16 input bitwise float32's; scan_batches,
dispatch_depth and bucket_seconds against the plain run; the kernel path
(its plain version here) within 1e-3 of the rfft path; the refusals."""

from pathlib import Path

import h5py
import jax
import numpy as np
import pandas as pd
import pytest
import torch

from uit_mobile_tpu import models as jax_models
from uit_mobile_tpu.ckpt.io import save_checkpoint as jax_save
from uit_mobile_tpu.evaluate import Evaluator as JaxEvaluator
from uit_mobile_tpu_torch.evaluate import Evaluator

torch.set_num_threads(1)

SR = 16000
PROB_TOL = dict(atol=1e-5, rtol=0)
METRIC_TOL = 1e-6


def build_world(root: Path) -> dict:
    """Manifests over one HDF5 file of int16 clips:
    - audioset: 8 clips of 1-3 s with AudioSet and keyword labels, every
      batch of 4 holding one 3 s clip (one padded shape, the crop path);
    - gsc: 8 one-second clips, keywords and filler, filenames with dirs;
    - strong: 5 clips of 2-3 s, one event interval a row (an unlabeled
      row, -1, and two events of one clip in one row);
    and two JAX checkpoints (uit_xxxs depth 1 at the 537-way head, and a
    13-way head for the strong scores) with a run_config."""
    rng = np.random.default_rng(0)
    h5 = root / "clips.h5"
    lens = [48000, 20000, 30000, 16000, 48000, 25000, 17000, 40000]
    as_rows, gsc_rows, strong_rows = [], [], []
    with h5py.File(h5, "w") as f:
        for i, n in enumerate(lens):
            f[f"as_{i}.wav"] = (rng.standard_normal(n) * 3000).astype(np.int16)
            labs = list(rng.choice(527, size=2, replace=False))
            if i % 3 == 0:
                labs.append(int(rng.integers(527, 537)))
            as_rows.append((f"as_{i}.wav", ";".join(map(str, labs)), str(h5)))
        for i in range(8):
            name = f"speech/word_{i}.wav"
            t = np.arange(SR) / SR
            f[name] = (np.sin(2 * np.pi * (300 + 200 * i) * t) * 8000
                       + rng.standard_normal(SR) * 500).astype(np.int16)
            lab = int(rng.integers(527, 537)) if i % 4 else int(rng.integers(0, 527))
            gsc_rows.append((name, str(lab), str(h5)))
        for i, n in enumerate([40000, 32000, 48000, 44000, 36000]):
            f[f"strong_{i}.wav"] = (rng.standard_normal(n) * 2000).astype(np.int16)
            for _ in range(3):
                on = float(rng.uniform(0, n / SR - 0.5))
                off = min(n / SR, on + float(rng.uniform(0.2, 1.5)))
                strong_rows.append((f"strong_{i}.wav", str(int(rng.integers(0, 13))), str(h5),
                                    f"{on:.3f}", f"{off:.3f}"))
        strong_rows.append(("strong_0.wav", "-1", str(h5), "0.0", "0.5"))
        strong_rows.append(("strong_1.wav", "3;7", str(h5), "0.4", "1.4"))
    world = {}
    for name, rows, cols in (("audioset", as_rows, ["filename", "labels", "hdf5path"]),
                             ("gsc", gsc_rows, ["filename", "labels", "hdf5path"]),
                             ("strong", strong_rows,
                              ["filename", "labels", "hdf5path", "from", "to"])):
        world[name] = str(root / f"{name}.tsv")
        pd.DataFrame(rows, columns=cols).to_csv(world[name], sep="\t", index=False)
    for name, outputdim in (("ckpt", 537), ("ckpt_strong", 13)):
        jcfg = jax_models.get_model_config("uit_xxxs", outputdim=outputdim, target_length=102,
                                           depth=1)
        params, state = jax_models.build(jcfg, jax.random.key(outputdim))
        world[name] = str(root / f"{name}.npz")
        jax_save(world[name], params, state, jcfg,
                 extra={"run_config": {"basename": False, "model": "uit_xxxs"}})
    return world


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return build_world(tmp_path_factory.mktemp("evalworld"))


def evaluators(ckpt, tmp: Path, **kw):
    """(port, JAX) Evaluators of one checkpoint on the CPU, each with its
    own report directory."""
    (tmp / "port").mkdir(exist_ok=True)
    (tmp / "jax").mkdir(exist_ok=True)
    port = Evaluator(ckpt, num_workers=0, device="cpu", report_dir=str(tmp / "port"), **kw)
    ref = JaxEvaluator(ckpt, num_workers=0, use_pallas=False, report_dir=str(tmp / "jax"), **kw)
    return port, ref


def same_results(got: dict, want: dict, tol: float = METRIC_TOL):
    assert set(got) == set(want), (set(got) ^ set(want))
    for k, w in want.items():
        g = got[k]
        if isinstance(w, dict):
            same_results(g, w, tol)
        elif np.ndim(w):
            np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                       atol=tol, rtol=0, equal_nan=True, err_msg=k)
        else:
            assert g == pytest.approx(float(w), abs=tol, rel=0, nan_ok=True), k


def same_report(tmp: Path, target: str):
    read = [(tmp / side / f"evaluation_{target}.txt").read_text().splitlines()
            for side in ("port", "jax")]
    assert read[0][0] == read[1][0] == f"{target} Results"
    assert sorted(read[0]) == sorted(read[1])


def test_audioset_matches_jax(world, tmp_path):
    port, ref = evaluators(world["ckpt"], tmp_path, batch_size=4)
    got = port.audioset(audioset_eval_data=world["audioset"],
                        dump_predictions=str(tmp_path / "port.npz"))
    want = ref.audioset(audioset_eval_data=world["audioset"],
                        dump_predictions=str(tmp_path / "jax.npz"))
    assert "mAPKWS" in got
    same_results(got, want)
    same_report(tmp_path, "Audioset")
    a = np.load(tmp_path / "port.npz", allow_pickle=True)
    b = np.load(tmp_path / "jax.npz", allow_pickle=True)
    np.testing.assert_allclose(a["preds"], b["preds"], **PROB_TOL)
    assert np.array_equal(a["targets"], b["targets"])
    assert list(a["filenames"]) == list(b["filenames"])


@pytest.mark.parametrize("kw", [
    dict(sweep=True, detailed=True),
    dict(tie_mode="reference", threshold=0.5, pad=True),
])
def test_gsc_matches_jax(world, tmp_path, kw):
    port, ref = evaluators(world["ckpt"], tmp_path, batch_size=4)
    got = port.gsc(eval_data=world["gsc"], dump_predictions=str(tmp_path / "port.npz"), **kw)
    want = ref.gsc(eval_data=world["gsc"], dump_predictions=str(tmp_path / "jax.npz"), **kw)
    same_results(got, want)
    same_report(tmp_path, "GSC")
    a, b = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    np.testing.assert_allclose(a["preds"], b["preds"], **PROB_TOL)


@pytest.mark.parametrize("per_class", [False, True])
def test_calibrate_matches_jax(world, tmp_path, per_class):
    port, ref = evaluators(world["ckpt"], tmp_path, batch_size=4)
    got = port.calibrate(eval_data=world["audioset"], per_class=per_class,
                         out=str(tmp_path / "port.json"))
    want = ref.calibrate(eval_data=world["audioset"], per_class=per_class,
                         out=str(tmp_path / "jax.json"))
    from uit_mobile_tpu_torch.evaluate import load_calibration

    T = load_calibration(tmp_path / "port.json")
    assert (T if not per_class else {i: t for i, t in enumerate(T) if t != 1.0}) \
        == got["temperature"]
    if per_class:
        # a class with one positive in 8 clips has a flat BCE minimum: its
        # temperature moves ~100x the 1e-7 probability drift between the
        # packages, so the per-class vector is held at 1e-4 relative (the
        # fit itself is held to 1e-9 in test_torch_eval_metrics.py)
        g, w = got.pop("temperature"), want.pop("temperature")
        assert set(g) == set(w)
        np.testing.assert_allclose([g[k] for k in w], list(w.values()), rtol=1e-4, atol=0)
    same_results(got, want)


STRONG_KW = [
    dict(sweep=(0.3, 0.5, 0.7), psds=True, median_kernel=3, merge_gap=0.1),
    dict(criterion="intersection", psds={"alpha_st": 0.2, "alpha_ct": 1.0, "e_max": 50.0},
         cttc=0.2, min_duration=0.2, dtype="int16"),
    dict(threshold={2: 0.45, "default": 0.52}, min_overlap=0.3, event_collar=0.5,
         thresholds_out=True),
]


@pytest.mark.parametrize("kw", STRONG_KW)
def test_strong_matches_jax(world, tmp_path, kw):
    kw = dict(kw)
    dtype = kw.pop("dtype", "float32")
    port, ref = evaluators(world["ckpt_strong"], tmp_path, batch_size=4, dtype=dtype)
    outs = {}
    for side, ev in (("port", port), ("jax", ref)):
        extra = {"dump_events": str(tmp_path / f"{side}.tsv")}
        if kw.get("thresholds_out"):
            extra["thresholds_out"] = str(tmp_path / f"{side}.json")
        outs[side] = ev.strong(eval_data=world["strong"], **{**kw, **extra})
    same_results(outs["port"], outs["jax"])
    same_report(tmp_path, "Strong")
    assert (tmp_path / "port.tsv").read_text() == (tmp_path / "jax.tsv").read_text()
    if kw.get("thresholds_out"):
        assert (tmp_path / "port.json").read_text() == (tmp_path / "jax.json").read_text()
    assert "_event_operating_curve" in outs["port"]


def test_test_sample_matches_jax(world, tmp_path, capsys):
    port, ref = evaluators(world["ckpt"], tmp_path)
    sample = str(Path(__file__).resolve().parent.parent / "samples" / "85b877b5_nohash_0.wav")
    got = port.test_sample(None, sample, topk=5)
    port_out = capsys.readouterr().out
    want = ref.test_sample(None, sample, topk=5)
    assert list(got) == list(want)
    np.testing.assert_allclose(list(got.values()), list(want.values()), **PROB_TOL)
    assert len(port_out.splitlines()) == 5


def test_int16_scan_depth_are_the_plain_run(world, tmp_path):
    """int16 PCM is bitwise float32's; K-batch blocks (with a shape change
    and a short tail) and any dispatch depth give the per-batch results."""
    def preds(**kw):
        ev = Evaluator(world["ckpt"], num_workers=0, device="cpu", batch_size=2,
                       report_dir=str(tmp_path), **kw)
        ev.audioset(audioset_eval_data=world["audioset"],
                    dump_predictions=str(tmp_path / "p.npz"))
        return np.load(tmp_path / "p.npz", allow_pickle=True)["preds"]

    plain = preds()
    for kw in (dict(dtype="int16"), dict(scan_batches=3), dict(scan_batches=2, dispatch_depth=1),
               dict(dispatch_depth=1), dict(dispatch_depth=16)):
        assert np.array_equal(preds(**kw), plain), kw


def test_bucket_seconds_matches_jax(world, tmp_path):
    port, ref = evaluators(world["ckpt"], tmp_path, batch_size=4, bucket_seconds=2.0)
    same_results(port.gsc(eval_data=world["gsc"], sweep=True),
                 ref.gsc(eval_data=world["gsc"], sweep=True))
    same_report(tmp_path, "GSC")


def test_kernel_path_and_fast_stay_near_exact(world, tmp_path):
    """use_kernel=True (the kernel's plain version on the CPU) exact and
    fast, within the JAX budget of 1e-3 of the rfft path."""
    def preds(**kw):
        ev = Evaluator(world["ckpt"], num_workers=0, device="cpu", batch_size=4,
                       report_dir=str(tmp_path), **kw)
        ev.gsc(eval_data=world["gsc"], dump_predictions=str(tmp_path / "p.npz"))
        return np.load(tmp_path / "p.npz")["preds"]

    ref = preds()
    for kw in (dict(use_kernel=True), dict(use_kernel=True, fast=True)):
        np.testing.assert_allclose(preds(**kw), ref, atol=1e-3, rtol=0)


def test_refusals(world):
    with pytest.raises(NotImplementedError, match="§A17"):
        Evaluator(world["ckpt"], device="cpu", data_parallel=True)
    with pytest.raises(ValueError, match="dtype"):
        Evaluator(world["ckpt"], device="cpu", dtype="float16")
    if not torch.cuda.is_available():  # the card by default
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            Evaluator(world["ckpt"])
    ev = Evaluator(None, device="cpu")
    with pytest.raises(ValueError, match="no model"):
        ev.gsc()
