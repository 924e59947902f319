"""The port's host-side evaluation functions (uit_mobile_tpu_torch.evaluate
metrics, calibration, events, psds) against the JAX package's on the same
seeded numpy inputs, within 1e-9 (float64): every registered metric with
tied scores, classes without positives or negatives and rows without
positives; gsc_accuracy in both tie modes and the KWS sweeps; the segment
functions; temperature calibration; event extraction and scoring (both
criteria, cross triggers); PSDS."""

import json

import numpy as np
import pytest

from uit_mobile_tpu.evaluate import calibration as j_cal
from uit_mobile_tpu.evaluate import events as j_ev
from uit_mobile_tpu.evaluate import metrics as j_met
from uit_mobile_tpu.evaluate import psds as j_psds
from uit_mobile_tpu_torch.evaluate import calibration as cal
from uit_mobile_tpu_torch.evaluate import events as ev
from uit_mobile_tpu_torch.evaluate import metrics as met
from uit_mobile_tpu_torch.evaluate import psds as psds_mod

TOL = dict(atol=1e-9, rtol=0)


def _data(n, c, seed, ties=False, degenerate=True):
    r = np.random.default_rng(seed)
    y_true = (r.uniform(size=(n, c)) > 0.7).astype(np.float32)
    y_pred = r.uniform(size=(n, c)).astype(np.float32)
    if degenerate:
        y_true[:, 1] = 0.0  # a class absent from the split
        y_true[:, 2] = 1.0  # a class present in every clip
    if ties:  # coarse scores: exact ties across positives and negatives
        y_pred = np.round(y_pred * 4) / 4
    return y_pred, y_true


def _same(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _same(got[k], want[k])
    elif np.ndim(want) or np.ndim(got):
        np.testing.assert_allclose(np.asarray(got, np.float64),
                                   np.asarray(want, np.float64), equal_nan=True, **TOL)
    elif np.isnan(want):
        assert np.isnan(got)
    else:
        assert got == pytest.approx(float(want), abs=1e-9, rel=0)


@pytest.mark.parametrize("degenerate", [True, False])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n, c", [(24, 9), (64, 540)])
def test_every_metric_matches_jax(n, c, ties, degenerate):
    """Every name of the JAX registry, on random data and on data with an
    absent class and an all-positive class (macro AUC then NaN, as
    scikit-learn gives it here)."""
    y_pred, y_true = _data(n, c, seed=n + c + ties, ties=ties, degenerate=degenerate)
    assert set(met.ALL_EVAL_METRICS) == set(j_met.ALL_EVAL_METRICS)
    names = sorted(j_met.ALL_EVAL_METRICS)
    want = j_met.compute_metrics(names, y_pred, y_true)
    got = met.compute_metrics(names, y_pred, y_true)
    for k in names:
        _same(got[k], want[k])
    assert np.isnan(got["AUC"]) == degenerate


@pytest.mark.parametrize("case", ["one_hot", "index", "multilabel", "no_positive_rows",
                                  "empty_and_full_rows"])
def test_error_rate_lwlrap_and_accuracy_branches(case):
    r = np.random.default_rng(7)
    p = r.uniform(size=(20, 6)).astype(np.float32)
    if case == "empty_and_full_rows":
        t = (r.uniform(size=(20, 6)) > 0.5).astype(np.float32)
        t[:4], t[4:7] = 0.0, 1.0
        p[4, 2] = p[4, 3]  # a tie inside a full row
    elif case == "one_hot":
        t = np.eye(6, dtype=np.float32)[r.integers(0, 6, 20)]
    elif case == "index":
        t = r.integers(0, 6, 20)
    elif case == "multilabel":
        t = (r.uniform(size=(20, 6)) > 0.5).astype(np.float32)
    else:
        t = np.zeros((20, 6), np.float32)
    _same(met.error_rate(p, t), j_met.error_rate(p, t))
    if t.ndim == 2:
        _same(met.lwlrap(p, t), j_met.lwlrap(p, t))
        _same(met.positive_multiclass_accuracy(p, t), j_met.positive_multiclass_accuracy(p, t))
        _same(met.roc_auc(p, t), j_met.roc_auc(p, t))


def _gsc_data(seed, n=60):
    """537-way scores with keyword and filler targets, exact ties between
    two AudioSet maxima on some rows and keywords near each threshold."""
    r = np.random.default_rng(seed)
    p = (r.uniform(size=(n, 537)) * 0.15).astype(np.float32)
    y = np.where(r.uniform(size=n) < 0.6, r.integers(527, 537, n), r.integers(0, 527, n))
    t = np.zeros((n, 537), np.float32)
    t[np.arange(n), y] = 1.0
    kw = r.integers(527, 537, n)
    p[np.arange(n), kw] = r.choice([0.05, 0.19, 0.2, 0.21, 0.5, 0.9], n)
    tie = np.arange(0, n, 3)
    p[tie, 5] = p[tie, 9] = 0.3  # bit-equal AudioSet maxima
    return p, t


@pytest.mark.parametrize("tie_mode", ["first", "reference"])
@pytest.mark.parametrize("threshold", [0.05, 0.2, 0.5])
def test_gsc_accuracy_and_sweeps_match_jax(tie_mode, threshold):
    p, t = _gsc_data(int(threshold * 100))
    _same(met.gsc_accuracy(p, t, threshold=threshold, tie_mode=tie_mode),
          j_met.gsc_accuracy(p, t, threshold=threshold, tie_mode=tie_mode))
    _same(met.kws_operating_metrics(p, t, threshold=threshold),
          j_met.kws_operating_metrics(p, t, threshold=threshold))
    _same(met.kws_threshold_sweep(p, t, tie_mode=tie_mode),
          j_met.kws_threshold_sweep(p, t, tie_mode=tie_mode))
    with pytest.raises(ValueError, match="tie_mode"):
        met.gsc_accuracy(p, t, tie_mode="last")


def _times(S, step=0.32, overlap_tail=True):
    t = np.stack([np.arange(S) * step, np.arange(S) * step + step], 1).astype(np.float64)
    if overlap_tail:  # the crop rule's tail window overlapping the one before
        t[-1] -= step / 3
    return t


@pytest.mark.parametrize("min_overlap", [0.2, 0.5, 1.0])
def test_segment_functions_match_jax(min_overlap):
    r = np.random.default_rng(3)
    times = _times(12)
    # onsets on exact segment edges and in between
    events = [(0, 0.32, 0.96), (3, 0.5, 0.51), (3, 1.0, 2.2), (5, 0.0, 3.84), (2, 2.56, 2.88)]
    want = j_met.segment_events_to_targets(times, events, 8, min_overlap=min_overlap)
    got = met.segment_events_to_targets(times, events, 8, min_overlap=min_overlap)
    np.testing.assert_array_equal(got, want)
    p = r.uniform(size=(12, 8)).astype(np.float32)
    for th in (0.3, 0.5, np.linspace(0.2, 0.8, 8)):
        assert met.segment_f1(p, got, threshold=th) == j_met.segment_f1(p, want, threshold=th)
        for a, b in zip(met.segment_counts(p, got, threshold=th),
                        j_met.segment_counts(p, want, threshold=th)):
            np.testing.assert_array_equal(a, b)
    counts = [c * 3 for c in j_met.segment_counts(p, want)]
    assert met.segment_scores_from_counts(*counts) == j_met.segment_scores_from_counts(*counts)


@pytest.mark.parametrize("per_class", [False, True])
def test_calibration_matches_jax(per_class, tmp_path):
    p, t = _data(80, 12, seed=11, degenerate=True)
    p = np.clip(p ** 3, 1e-6, 1 - 1e-6)  # over-confident scores
    _same(cal.reliability(p, t, n_bins=10), j_cal.reliability(p, t, n_bins=10))
    _same(cal.ece(p, t), j_cal.ece(p, t))
    T = cal.fit_temperature(p, t, per_class=per_class)
    _same(T, j_cal.fit_temperature(p, t, per_class=per_class))
    np.testing.assert_array_equal(cal.apply_temperature(p, T), j_cal.apply_temperature(p, T))
    cal.save_calibration(tmp_path / "c.json", T, meta={"n": 80})
    _same(cal.load_calibration(tmp_path / "c.json"), j_cal.load_calibration(tmp_path / "c.json"))
    assert json.loads((tmp_path / "c.json").read_text())["n"] == 80


def _clip_world(seed, n_clips=10, n_cls=5):
    r = np.random.default_rng(seed)
    clips = []
    for _ in range(n_clips):
        S = int(r.integers(6, 14))
        times = _times(S, 0.5, overlap_tail=bool(r.integers(0, 2)))
        probs = r.uniform(size=(S, n_cls)).astype(np.float32)
        refs = []
        for c in range(n_cls):
            for _ in range(int(r.integers(0, 3))):
                on = float(r.uniform(0, S * 0.4))
                refs.append((c, on, on + float(r.uniform(0.3, 2.0))))
        clips.append((times, probs, refs))
    return clips


@pytest.mark.parametrize("kw", [
    dict(threshold=0.5),
    dict(threshold=0.6, median_kernel=3, merge_gap=0.25, min_duration=0.6),
    dict(threshold={1: 0.3, 3: 0.8, "default": 0.55}, median_kernel=5),
    dict(threshold=np.linspace(0.3, 0.7, 5)),
])
def test_extract_events_matches_jax(kw):
    for times, probs, _ in _clip_world(5):
        assert ev.extract_events(times, probs, **kw) == j_ev.extract_events(times, probs, **kw)
        np.testing.assert_array_equal(ev.median_filter_probs(probs, 3),
                                      j_ev.median_filter_probs(probs, 3))
    with pytest.raises(ValueError, match="odd"):
        ev.median_filter_probs(probs, 2)


@pytest.mark.parametrize("scorer_kw", [
    dict(),
    dict(t_collar=0.5, offset_collar_rate=0.5),
    dict(offset_condition=False),
    dict(criterion="intersection", dtc=0.3, gtc=0.4),
    dict(criterion="intersection", count_cross_triggers=True, cttc=0.2),
])
def test_event_scorer_matches_jax(scorer_kw):
    mine, theirs = ev.EventScorer(**scorer_kw), j_ev.EventScorer(**scorer_kw)
    pairs = []
    for times, probs, refs in _clip_world(9):
        pred = j_ev.extract_events(times, probs, threshold=0.6, median_kernel=3)
        mine.add_clip(pred, refs)
        theirs.add_clip(pred, refs)
        pairs.append((pred, refs))
    _same(mine.scores(), theirs.scores())
    assert (mine.tp, mine.fp, mine.fn, mine.ct, mine.ref_duration) == \
        (theirs.tp, theirs.fp, theirs.fn, theirs.ct, theirs.ref_duration)
    kw = {k: v for k, v in scorer_kw.items() if k not in ("count_cross_triggers", "cttc")}
    _same(ev.event_based_scores(pairs, **kw), j_ev.event_based_scores(pairs, **kw))


def test_thresholds_round_trip_matches_jax(tmp_path):
    spec = {0: 0.3, 4: 0.7}
    ev.save_thresholds(tmp_path / "a.json", spec, default=0.45)
    j_ev.save_thresholds(tmp_path / "b.json", spec, default=0.45)
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    loaded = ev.load_thresholds(tmp_path / "a.json")
    assert loaded == j_ev.load_thresholds(tmp_path / "b.json")
    np.testing.assert_array_equal(ev.per_class_thresholds(loaded, 6),
                                  j_ev.per_class_thresholds(loaded, 6))
    with pytest.raises(ValueError, match="out of range"):
        ev.per_class_thresholds({9: 0.1}, 6)


@pytest.mark.parametrize("opts", [dict(), dict(alpha_st=0.5, e_max=50.0),
                                  dict(alpha_ct=1.0), dict(alpha_ct=0.5, alpha_st=0.2)])
def test_psds_matches_jax(opts):
    ths = (0.2, 0.4, 0.6, 0.8)
    scorers = {th: j_ev.EventScorer(criterion="intersection", count_cross_triggers=True)
               for th in ths}
    total = 0.0
    for times, probs, refs in _clip_world(21, n_clips=14):
        total += times[-1, 1]
        for th in ths:
            scorers[th].add_clip(j_ev.extract_events(times, probs, threshold=th), refs)
    points = [{c: (sc.tp[c], sc.fp[c], sc.fn[c]) for c in set(sc.tp) | set(sc.fp) | set(sc.fn)}
              for sc in scorers.values()]
    kw = dict(opts, duration_hours=total / 3600.0)
    if opts.get("alpha_ct"):
        kw.update(ct_points=[dict(sc.ct) for sc in scorers.values()],
                  ref_duration_hours={c: s / 3600.0
                                      for c, s in scorers[0.2].ref_duration.items()})
    _same(psds_mod.psds(points, **kw), j_psds.psds(points, **kw))
    classes = sorted({c for op in points for c in op})
    _same(psds_mod.roc_per_class(points, kw["duration_hours"], classes),
          j_psds.roc_per_class(points, kw["duration_hours"], classes))
