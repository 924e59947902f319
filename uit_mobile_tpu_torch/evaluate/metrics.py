"""Validation metrics in numpy, counterpart of the part of
``uit_mobile_tpu/evaluate/metrics.py`` that the Trainer uses.

The JAX package computes average precision with scikit-learn; here it is
numpy (the card's machine has no scikit-learn), held to the JAX package's
values by the tests: per class, the ranking's precision at every distinct
score threshold, weighted by the recall step there (sklearn's
``average_precision_score``), with NaN for a class that has no positive so
that the mean skips it.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List

import numpy as np


def average_precision(y_score: np.ndarray, y_true: np.ndarray) -> float:
    """AP of one class: sum over distinct thresholds (descending) of
    (recall_i - recall_{i-1}) * precision_i. NaN without positives."""
    y_true = np.asarray(y_true) > 0
    n_pos = int(y_true.sum())
    if n_pos == 0:
        return float("nan")
    order = np.argsort(-np.asarray(y_score), kind="mergesort")
    score, hit = np.asarray(y_score)[order], y_true[order]
    # the last index of each run of tied scores is one threshold
    last = np.r_[np.flatnonzero(np.diff(score)), score.size - 1]
    tps = np.cumsum(hit, dtype=np.float64)[last]
    precision = tps / (last + 1.0)
    recall = tps / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall]) * precision))


def ap_per_class(y_pred: np.ndarray, y_true: np.ndarray) -> np.ndarray:
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    return np.array([average_precision(y_pred[:, c], y_true[:, c])
                     for c in range(y_true.shape[1])], dtype=np.float64)


def bce(y_pred, y_true, eps=1e-7) -> float:
    p = np.clip(y_pred, eps, 1 - eps)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log1p(-p)))


ALL_EVAL_METRICS: Dict[str, Callable[[np.ndarray, np.ndarray], float | np.ndarray]] = {
    "mAP": lambda p, t: float(np.nanmean(ap_per_class(p, t))),
    "AP": ap_per_class,
    "mAPAudioset": lambda p, t: float(np.nanmean(ap_per_class(p[:, :527], t[:, :527]))),
    "mAPKWS": lambda p, t: float(np.nanmean(ap_per_class(p[:, 527:], t[:, 527:]))),
    "BCELoss": bce,
}


def compute_metrics(names: List[str], y_pred: np.ndarray, y_true: np.ndarray) -> dict:
    unknown = [n for n in names if n not in ALL_EVAL_METRICS]
    if unknown:
        raise KeyError(f"metrics {unknown} are not yet ported; known: {sorted(ALL_EVAL_METRICS)}")
    with warnings.catch_warnings():  # nanmean of an all-NaN slice is NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        return {name: ALL_EVAL_METRICS[name](y_pred, y_true) for name in names}
