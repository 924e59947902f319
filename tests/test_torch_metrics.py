"""The port's numpy metrics (uit_mobile_tpu_torch.evaluate.metrics) against
the JAX package's scikit-learn ones, within 1e-9: per-class average
precision with tied scores, classes without positives (NaN, skipped by the
mean) and all-positive classes, and every metric the Trainer reports."""

import numpy as np
import pytest

from uit_mobile_tpu.evaluate.metrics import ALL_EVAL_METRICS as JAX_METRICS
from uit_mobile_tpu.evaluate.metrics import compute_metrics as jax_compute_metrics
from uit_mobile_tpu_torch.evaluate import ALL_EVAL_METRICS, average_precision, compute_metrics


def _data(n, c, seed, ties=False):
    r = np.random.default_rng(seed)
    y_true = (r.uniform(size=(n, c)) > 0.8).astype(np.float32)
    y_true[:, 3] = 0.0  # a class absent from the split
    y_true[:, 4] = 1.0  # a class present in every clip
    y_pred = r.uniform(size=(n, c)).astype(np.float32)
    if ties:  # coarse scores: many exact ties, across positives and negatives
        y_pred = np.round(y_pred * 4) / 4
    return y_pred, y_true


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n, c", [(16, 8), (64, 540)])
def test_ap_per_class_matches_sklearn(n, c, ties):
    y_pred, y_true = _data(n, c, seed=n + c, ties=ties)
    want = np.asarray(JAX_METRICS["AP"](y_pred, y_true))
    got = ALL_EVAL_METRICS["AP"](y_pred, y_true)
    assert np.isnan(got[3]) and np.isnan(want[3])
    np.testing.assert_allclose(got, want, atol=1e-9, rtol=0, equal_nan=True)


@pytest.mark.parametrize("ties", [False, True])
def test_compute_metrics_matches_jax(ties):
    y_pred, y_true = _data(48, 537, seed=3, ties=ties)
    names = ["mAP", "mAPAudioset", "mAPKWS", "BCELoss"]
    want = jax_compute_metrics(names, y_pred, y_true)
    got = compute_metrics(names, y_pred, y_true)
    for k in names:
        assert got[k] == pytest.approx(float(want[k]), abs=1e-9, rel=0), k


def test_average_precision_edge_cases_and_unported_metrics():
    assert average_precision(np.array([0.9, 0.1, 0.5]), np.array([1, 0, 1])) == 1.0
    # one positive ranked second of three: AP = precision at its rank = 1/2
    assert average_precision(np.array([0.9, 0.5, 0.1]), np.array([0, 1, 0])) == 0.5
    assert np.isnan(average_precision(np.array([0.3, 0.2]), np.array([0, 0])))
    with pytest.raises(KeyError, match="unknown metrics"):
        compute_metrics(["NoSuchMetric"], np.zeros((2, 3)), np.ones((2, 3)))
