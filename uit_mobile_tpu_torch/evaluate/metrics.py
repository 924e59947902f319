"""Metric suite in numpy, counterpart of ``uit_mobile_tpu/evaluate/metrics.py``.

The JAX package computes its metrics with scikit-learn; here they are numpy
(the card's machine has no scikit-learn), held to the JAX package's values
by the tests:

- average precision per class: the ranking's precision at every distinct
  score threshold, weighted by the recall step there, NaN for a class
  without positives so that the mean skips it;
- precision/recall/F1 at the reference's threshold 0.2, per class, macro
  and micro, with scikit-learn's ``zero_division=0`` (a ratio whose
  denominator is 0 counts 0, and the macro mean includes it);
- ROC-AUC per class as the Mann-Whitney statistic with average ranks for
  ties (the area under scikit-learn's ROC staircase); a class whose targets
  hold one value only is NaN, and so is the macro mean, as scikit-learn
  1.9 gives it (older versions raised, which the JAX wrapper turned into
  0.0);
- label-ranking average precision (lwlrap) over the rows with a positive,
  weighted by their positives, a row whose labels are all positive scoring
  1, as scikit-learn's ``label_ranking_average_precision_score`` does;
- the GSC keyword-spotting protocol and the strong-label segment scores,
  which are numpy in both packages.
"""

from __future__ import annotations

import warnings
from typing import Callable, Dict, List

import numpy as np

THRESHOLD = 0.2  # the reference's fixed decision threshold


def _binarize(y_pred):
    return (np.asarray(y_pred) > THRESHOLD).astype(np.float32)


def _ratio(num, den) -> np.ndarray:
    """num / den elementwise in float64, 0 where den is 0 (zero_division=0)."""
    num, den = np.asarray(num, np.float64), np.asarray(den, np.float64)
    return np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)


def _counts(y_pred, y_true):
    """Per-class (tp, fp, fn) int64 of binary predictions and targets."""
    p, t = np.asarray(y_pred) > 0, np.asarray(y_true) > 0
    return ((p & t).sum(0).astype(np.int64), (p & ~t).sum(0).astype(np.int64),
            (~p & t).sum(0).astype(np.int64))


def precision(y_pred, y_true, average=None):
    """Precision of binary predictions: per class (average=None), the mean
    over classes ('macro') or from the summed counts ('micro')."""
    tp, fp, _ = _counts(y_pred, y_true)
    if average == "micro":
        return float(_ratio(tp.sum(), tp.sum() + fp.sum()))
    per = _ratio(tp, tp + fp)
    return float(per.mean()) if average == "macro" else per


def recall(y_pred, y_true, average=None):
    tp, _, fn = _counts(y_pred, y_true)
    if average == "micro":
        return float(_ratio(tp.sum(), tp.sum() + fn.sum()))
    per = _ratio(tp, tp + fn)
    return float(per.mean()) if average == "macro" else per


def f1(y_pred, y_true, average=None):
    """F1 = 2 tp / (2 tp + fp + fn), 0 where nothing was predicted or true."""
    tp, fp, fn = _counts(y_pred, y_true)
    if average == "micro":
        tp, fp, fn = tp.sum(), fp.sum(), fn.sum()
        return float(_ratio(2 * tp, 2 * tp + fp + fn))
    per = _ratio(2 * tp, 2 * tp + fp + fn)
    return float(per.mean()) if average == "macro" else per


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
    precision_at = tps / (last + 1.0)
    recall_at = tps / n_pos
    return float(np.sum(np.diff(np.r_[0.0, recall_at]) * precision_at))


def ap_per_class(y_pred: np.ndarray, y_true: np.ndarray) -> np.ndarray:
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    return np.array([average_precision(y_pred[:, c], y_true[:, c])
                     for c in range(y_true.shape[1])], dtype=np.float64)


def _average_ranks(x: np.ndarray) -> np.ndarray:
    """1-based ranks of x ascending, tied values sharing their mean rank."""
    order = np.argsort(x, kind="mergesort")
    xs = x[order]
    starts = np.r_[0, np.flatnonzero(np.diff(xs)) + 1]
    ends = np.r_[starts[1:], xs.size]
    mean_rank = (starts + ends + 1) / 2.0  # ranks starts+1 .. ends
    ranks = np.empty(x.size, np.float64)
    ranks[order] = np.repeat(mean_rank, ends - starts)
    return ranks


def roc_auc_per_class(y_pred, y_true) -> np.ndarray:
    """(C,) ROC-AUC: P(score of a positive > score of a negative), ties
    counting one half; NaN where a class has no positive or no negative."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true) > 0
    out = np.full(y_true.shape[1], np.nan)
    for c in range(y_true.shape[1]):
        pos = y_true[:, c]
        n_pos = int(pos.sum())
        n_neg = pos.size - n_pos
        if n_pos and n_neg:
            r = _average_ranks(y_pred[:, c])
            out[c] = (r[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)
    return out


def roc_auc(y_pred, y_true) -> float:
    """Macro ROC-AUC: the mean of roc_auc_per_class (NaN if any class is)."""
    return float(np.mean(roc_auc_per_class(y_pred, y_true)))


def lwlrap(y_pred: np.ndarray, y_true: np.ndarray) -> float:
    """Label-weighted label-ranking AP (reference utils.py:42-54): each row
    with a positive scores the mean over its positives of (positives
    ranked at or above it) / (labels ranked at or above it), rows weighted
    by their number of positives; 0.0 when no row has a positive."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true) > 0
    weight = y_true.sum(axis=1)
    rows = np.flatnonzero(weight > 0)
    if rows.size == 0:  # no positive rows: score is undefined, not a crash
        return 0.0
    n_labels = y_true.shape[1]
    total = 0.0
    for i in rows:
        rel = np.flatnonzero(y_true[i])
        if rel.size == n_labels:
            aux = 1.0
        else:
            s = y_pred[i]
            all_sorted, rel_sorted = np.sort(s), np.sort(s[rel])
            # labels (all / positive) whose score is >= each positive's
            rank = n_labels - np.searchsorted(all_sorted, s[rel], side="left")
            hits = rel.size - np.searchsorted(rel_sorted, s[rel], side="left")
            aux = float(np.mean(hits / rank))
        total += aux * weight[i]
    return float(total / weight[rows].sum())


def _accuracy(a, b) -> float:
    """Share of equal rows (1-D: equal entries), NaN when empty."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape[0] == 0:
        return float("nan")
    eq = a == b
    return float(np.mean(eq if eq.ndim == 1 else eq.all(axis=1)))


def positive_multiclass_accuracy(y_pred, y_true) -> float:
    """Argmax accuracy over samples that have at least one positive label
    (reference utils.py:68-73)."""
    y_pred, y_true = np.asarray(y_pred), np.asarray(y_true)
    valid = y_true.max(-1) > 0
    if not valid.any():  # no positive rows: undefined, not a crash
        return 0.0
    return _accuracy(y_true[valid].argmax(-1), y_pred[valid].argmax(-1))


def bce(y_pred, y_true, eps=1e-7) -> float:
    p = np.clip(y_pred, eps, 1 - eps)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log1p(-p)))


def error_rate(y_pred, y_true) -> float:
    """1 - accuracy: single-label targets (one-hot rows or an index
    vector) score argmax accuracy; multilabel targets exact-match subset
    accuracy of predictions binarized at 0.5 (the JAX package's working
    reading of the reference's raw ``accuracy_score``)."""
    t = np.asarray(y_true)
    p = np.asarray(y_pred)
    if t.ndim == 1:
        pred = p.argmax(-1) if p.ndim > 1 else p
        return float(1.0 - np.nan_to_num(_accuracy(t, pred)))
    one_hot = np.isin(t, (0.0, 1.0)).all() and np.allclose(t.sum(-1), 1.0)
    if one_hot:
        return float(1.0 - np.nan_to_num(_accuracy(t.argmax(-1), p.argmax(-1))))
    return float(1.0 - np.nan_to_num(_accuracy(t, (p >= 0.5).astype(t.dtype))))


def _ece(p, t):
    from .calibration import ece

    return ece(p, t)


ALL_EVAL_METRICS: Dict[str, Callable[[np.ndarray, np.ndarray], float | np.ndarray]] = {
    "mAP": lambda p, t: float(np.nanmean(ap_per_class(p, t))),
    "AP": ap_per_class,
    "mAPAudioset": lambda p, t: float(np.nanmean(ap_per_class(p[:, :527], t[:, :527]))),
    "mAPKWS": lambda p, t: float(np.nanmean(ap_per_class(p[:, 527:], t[:, 527:]))),
    # the reference registry spells it 'lwlwrap' (utils.py:153); both names
    "lwlwrap": lwlrap,
    "lwlrap": lwlrap,
    "AUC": roc_auc,
    "PositiveMultiClass_Accuracy": positive_multiclass_accuracy,
    "Precision": lambda p, t: precision(_binarize(p), t),
    "Recall": lambda p, t: recall(_binarize(p), t),
    "Macro_Precision": lambda p, t: precision(_binarize(p), t, "macro"),
    "Macro_Recall": lambda p, t: recall(_binarize(p), t, "macro"),
    "Micro_Precision": lambda p, t: precision(_binarize(p), t, "micro"),
    "Micro_Recall": lambda p, t: recall(_binarize(p), t, "micro"),
    "Macro_F1": lambda p, t: f1(_binarize(p), t, "macro"),
    "Micro_F1": lambda p, t: f1(_binarize(p), t, "micro"),
    "BCELoss": bce,
    "ErrorRate": error_rate,
    # expected calibration error over all (clip, class) cells (15 bins)
    "ECE": _ece,
}


def compute_metrics(names: List[str], y_pred: np.ndarray, y_true: np.ndarray) -> dict:
    unknown = [n for n in names if n not in ALL_EVAL_METRICS]
    if unknown:
        raise KeyError(f"unknown metrics {unknown}; known: {sorted(ALL_EVAL_METRICS)}")
    with warnings.catch_warnings():  # nanmean of an all-NaN slice is NaN
        warnings.simplefilter("ignore", RuntimeWarning)
        return {name: ALL_EVAL_METRICS[name](y_pred, y_true) for name in names}


def kws_operating_metrics(y_pred: np.ndarray, y_true_multihot: np.ndarray,
                          threshold: float = 0.2, n_audioset: int = 527) -> dict:
    """Per-keyword false-reject rate and recall, and the filler false-accept
    rate (any keyword fires on a non-keyword clip), at ``threshold``."""
    y_pred = np.asarray(y_pred, dtype=np.float32)
    y = np.asarray(y_true_multihot).argmax(-1)
    kw_scores = y_pred[:, n_audioset:]
    fires = kw_scores >= threshold  # (B, n_kw)

    filler = y < n_audioset
    out: dict = {}
    if filler.any():
        out["filler_false_accept_rate"] = float(fires[filler].any(-1).mean())
    frr, rec = {}, {}
    for k in range(kw_scores.shape[1]):
        cls = n_audioset + k
        pos = y == cls
        if pos.any():
            fired = fires[pos, k]
            frr[cls] = float(1.0 - fired.mean())
            # a hit needs the fired keyword to be the top-scoring keyword too
            top_kw = kw_scores[pos].argmax(-1) == k
            rec[cls] = float((fired & top_kw).mean())
    out["false_reject_rate_per_keyword"] = frr
    out["recall_per_keyword"] = rec
    if frr:
        out["macro_false_reject_rate"] = float(np.mean(list(frr.values())))
    return out


def gsc_accuracy(y_pred: np.ndarray, y_true_multihot: np.ndarray,
                 threshold: float = 0.2, n_audioset: int = 527,
                 tie_mode: str = "first") -> float:
    """The GSC keyword-spotting accuracy protocol (reference
    evaluate.py:212-229), as the JAX package states it:

    1. among the AudioSet classes keep only the per-sample maximum score;
    2. a target that is an AudioSet index (a "filler" word) is rewritten to
       the predicted AudioSet argmax: any AudioSet prediction counts as a
       correct rejection;
    3. if any keyword score >= threshold, the surviving AudioSet score is
       zeroed (keywords take precedence);
    4. prediction = argmax of the masked vector.

    tie_mode='first' keeps only the first of exact-float-tied AudioSet
    maxima; 'reference' keeps every tied column, as the reference's
    equality mask does, while step 3 still zeros only the first.
    GSC Accuracy@0.2 = 97.76 for uit_xs is a baseline parity gate."""
    if tie_mode not in ("first", "reference"):
        raise ValueError(f"unknown tie_mode {tie_mode!r}; expected 'first' or 'reference'")
    y_pred = np.asarray(y_pred, dtype=np.float32).copy()
    y = np.asarray(y_true_multihot).argmax(-1)

    as_scores = y_pred[:, :n_audioset]
    as_argmax = as_scores.argmax(-1)
    rows = np.arange(len(as_scores))
    if tie_mode == "reference":
        masked_as = np.where(as_scores == as_scores.max(-1, keepdims=True), as_scores, 0.0)
    else:
        masked_as = np.zeros_like(as_scores)
        masked_as[rows, as_argmax] = as_scores[rows, as_argmax]
    y_pred[:, :n_audioset] = masked_as

    y = np.where(y < n_audioset, as_argmax, y)
    any_kw = (y_pred[:, n_audioset:] >= threshold).any(-1)
    y_pred[rows, as_argmax] = np.where(any_kw, 0.0, y_pred[rows, as_argmax])
    return float((y_pred.argmax(-1) == y).mean())


def kws_threshold_sweep(y_pred: np.ndarray, y_true_multihot: np.ndarray,
                        thresholds=None, n_audioset: int = 527,
                        tie_mode: str = "first") -> dict:
    """GSC accuracy, filler false-accept rate and macro false-reject rate
    at each threshold, the headline's tie_mode throughout ->
    {threshold: {metric: value}}, sorted by threshold."""
    if thresholds is None:
        thresholds = (0.05, 0.1, 0.2, 0.3, 0.5, 0.7, 0.9)
    out: dict = {}
    for t in sorted(thresholds):
        op = kws_operating_metrics(y_pred, y_true_multihot, threshold=t,
                                   n_audioset=n_audioset)
        row = {"Accuracy": gsc_accuracy(y_pred, y_true_multihot, threshold=t,
                                        n_audioset=n_audioset, tie_mode=tie_mode)}
        for k in ("filler_false_accept_rate", "macro_false_reject_rate"):
            if k in op:
                row[k] = op[k]
        out[float(t)] = row
    return out


# ----------------------------------------------------- strong-label segments

def segment_events_to_targets(times: np.ndarray, events, num_classes: int,
                              min_overlap: float = 0.5) -> np.ndarray:
    """Strong labels rasterized onto framewise segments -> (S, num_classes)
    multi-hot. times: (S, 2) [start, end) seconds, kept float64; events:
    (class_index, onset_s, offset_s). A segment is positive for a class
    when the event covers at least ``min_overlap`` of the segment, or of
    the event where that is shorter."""
    times = np.asarray(times, dtype=np.float64)
    out = np.zeros((times.shape[0], num_classes), dtype=np.float32)
    seg_len = times[:, 1] - times[:, 0]
    for cls, on, off in events:
        ov = np.minimum(times[:, 1], off) - np.maximum(times[:, 0], on)
        denom = np.minimum(seg_len, max(off - on, 1e-9))
        out[ov / np.maximum(denom, 1e-9) >= min_overlap, int(cls)] = 1.0
    return out


def segment_counts(framewise_probs: np.ndarray, segment_targets: np.ndarray,
                   threshold=0.5):
    """Per-class (TP, FP, FN) int64 of segments binarized at ``threshold``
    (a scalar or a (C,) vector), to accumulate across clips."""
    p = np.asarray(framewise_probs) >= threshold
    t = np.asarray(segment_targets) >= 0.5
    if p.shape != t.shape:
        raise ValueError(f"probs {p.shape} and targets {t.shape} differ in shape")
    return _counts(p, t)


def segment_scores_from_counts(tp: np.ndarray, fp: np.ndarray, fn: np.ndarray) -> dict:
    """Segment micro F1/precision/recall from the summed counts and macro
    F1 over all C classes (absent classes count 0)."""
    tp, fp, fn = (np.asarray(x, np.int64) for x in (tp, fp, fn))

    def f1_of(tp, fp, fn):
        denom = 2 * tp + fp + fn
        return np.where(denom > 0, 2 * tp / np.maximum(denom, 1), 0.0)

    TP, FP, FN = tp.sum(), fp.sum(), fn.sum()
    return {
        "Segment_Micro_F1": float(f1_of(TP, FP, FN)),
        "Segment_Macro_F1": float(f1_of(tp, fp, fn).mean()),
        "Segment_Micro_Precision": float(TP / (TP + FP) if TP + FP else 0.0),
        "Segment_Micro_Recall": float(TP / (TP + FN) if TP + FN else 0.0),
    }


def segment_f1(framewise_probs: np.ndarray, segment_targets: np.ndarray,
               threshold: float = 0.5) -> dict:
    """Segment-based strong-label scores of stacked (S, C) segments at
    ``threshold``: micro/macro F1, micro precision and recall."""
    return segment_scores_from_counts(*segment_counts(framewise_probs, segment_targets,
                                                      threshold))
