"""Probability calibration for the multi-label tagging outputs, a copy of
``uit_mobile_tpu/evaluate/calibration.py`` (numpy only, host-side).

The models emit sigmoid probabilities (reference models/uit.py:358-360 —
probs, not logits), trained with BCE; like most over-parameterized
classifiers they are not guaranteed calibrated: a clip scored 0.8 for
"Water" is not empirically right 80% of the time. For a tagging service
whose downstream consumers threshold or combine scores (the per-class
operating thresholds flow in evaluate.events, the SED event extraction),
calibrated probabilities make a single threshold mean the same thing
across classes.

The reference has nothing comparable. This module adds the standard
post-hoc recipe (Guo et al. 2017, "On Calibration of Modern Neural
Networks"), adapted to multi-label sigmoid outputs:

- ``ece``: expected calibration error over all (clip, class) cells —
  each cell is an independent Bernoulli prediction, so the binary
  binned-reliability definition applies directly (micro over cells).
- ``reliability``: the per-bin (confidence, empirical accuracy, count)
  curve behind it, for plots/reports.
- ``fit_temperature``: temperature scaling on the inverse-sigmoid
  logits — scalar (one T for the whole head) or per-class (C,) vector,
  fit by minimizing BCE on held-out validation outputs. Fitting is a
  bounded 1-D search per class (BCE in T is smooth and unimodal on
  real outputs; golden-section needs no derivatives and cannot
  diverge), vectorized over classes.
- ``apply_temperature``: probs -> calibrated probs (works host-side on
  the (B, C) output block; the hot path on device is untouched).

Everything is numpy + host-side: calibration is fit once from a
validation epoch's (probs, targets) and shipped as a tiny JSON
(``uit-evaluate calibrate``), mirroring the per-class thresholds flow.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Tuple, Union

import numpy as np

_EPS = 1e-7


def _logit(p: np.ndarray) -> np.ndarray:
    p = np.clip(np.asarray(p, dtype=np.float64), _EPS, 1.0 - _EPS)
    return np.log(p) - np.log1p(-p)


def _sigmoid(z: np.ndarray) -> np.ndarray:
    out = np.empty_like(z)
    pos = z >= 0
    out[pos] = 1.0 / (1.0 + np.exp(-z[pos]))
    ez = np.exp(z[~pos])
    out[~pos] = ez / (1.0 + ez)
    return out


def reliability(y_pred: np.ndarray, y_true: np.ndarray,
                n_bins: int = 15) -> dict:
    """Binned reliability curve over all (clip, class) cells.

    Returns ``{"confidence": (n_bins,), "accuracy": (n_bins,),
    "count": (n_bins,)}`` — mean predicted probability, empirical
    positive rate, and cell count per equal-width bin over [0, 1].
    Empty bins hold NaN confidence/accuracy and count 0.
    """
    p = np.asarray(y_pred, dtype=np.float64).ravel()
    t = np.asarray(y_true, dtype=np.float64).ravel()
    if p.shape != t.shape:
        raise ValueError(f"shape mismatch: probs {p.shape} vs targets {t.shape}")
    # right-closed bins like the standard formulation; p==0 lands in bin 0
    idx = np.minimum((p * n_bins).astype(np.int64), n_bins - 1)
    count = np.bincount(idx, minlength=n_bins).astype(np.float64)
    conf_sum = np.bincount(idx, weights=p, minlength=n_bins)
    acc_sum = np.bincount(idx, weights=t, minlength=n_bins)
    with np.errstate(invalid="ignore", divide="ignore"):
        conf = np.where(count > 0, conf_sum / count, np.nan)
        acc = np.where(count > 0, acc_sum / count, np.nan)
    return {"confidence": conf, "accuracy": acc, "count": count}


def ece(y_pred: np.ndarray, y_true: np.ndarray, n_bins: int = 15) -> float:
    """Expected calibration error (micro over all (clip, class) cells):
    ``sum_b (count_b / N) * |confidence_b - accuracy_b|``."""
    rel = reliability(y_pred, y_true, n_bins=n_bins)
    count = rel["count"]
    n = count.sum()
    if n == 0:
        return 0.0
    gap = np.abs(rel["confidence"] - rel["accuracy"])
    return float(np.nansum(count / n * gap))


def _bce_at(z: np.ndarray, t: np.ndarray, inv_T: np.ndarray) -> np.ndarray:
    """Per-class mean BCE of sigmoid(z * inv_T): (B, C) x (C,) -> (C,).
    log(1+e^x) computed stably via logaddexp."""
    zz = z * inv_T
    # BCE = softplus(z) - t*z   (softplus(x) = log(1 + e^x))
    return np.mean(np.logaddexp(0.0, zz) - t * zz, axis=0)


def fit_temperature(y_pred: np.ndarray, y_true: np.ndarray, *,
                    per_class: bool = False,
                    bounds: Tuple[float, float] = (0.05, 20.0),
                    iters: int = 40) -> Union[float, np.ndarray]:
    """Fit temperature(s) T minimizing validation BCE of
    ``sigmoid(logit(p) / T)``.

    per_class=False (default): one scalar T for the whole 537-way head —
    the classic, hardest-to-overfit variant. per_class=True: a (C,)
    vector, one T per class (analogous to the per-class operating
    thresholds; needs enough positives per class to be trustworthy —
    classes with NO positives in the split keep T=1).

    Golden-section search on log T within ``bounds``: BCE(T) is smooth
    and unimodal in practice, and the bracketed search cannot diverge on
    degenerate inputs (all-negative classes give a monotone objective —
    the search then converges to a bound, which the no-positives guard
    overrides with 1.0).
    """
    z = _logit(y_pred)
    t = np.asarray(y_true, dtype=np.float64)
    if z.ndim != 2 or z.shape != t.shape:
        raise ValueError(f"need matching (B, C) arrays, got {z.shape} vs {t.shape}")
    if t.sum() == 0:
        # no positives anywhere: BCE is monotone in T (colder is always
        # "better") — any fitted T would be an artifact of the bounds
        return np.ones(t.shape[1]) if per_class else 1.0
    n_class = z.shape[1] if per_class else 1
    if not per_class:
        z = z.reshape(-1, 1)
        t = t.reshape(-1, 1)

    lo = np.full(n_class, np.log(bounds[0]))
    hi = np.full(n_class, np.log(bounds[1]))
    gr = (np.sqrt(5.0) - 1.0) / 2.0  # 1/phi
    c = hi - gr * (hi - lo)
    d = lo + gr * (hi - lo)
    fc = _bce_at(z, t, np.exp(-c))
    fd = _bce_at(z, t, np.exp(-d))
    for _ in range(iters):
        take_c = fc < fd  # minimum is in [lo, d]
        hi = np.where(take_c, d, hi)
        lo = np.where(take_c, lo, c)
        c = hi - gr * (hi - lo)
        d = lo + gr * (hi - lo)
        fc = _bce_at(z, t, np.exp(-c))
        fd = _bce_at(z, t, np.exp(-d))
    T = np.exp((lo + hi) / 2.0)
    if not per_class:
        return float(T[0])
    # classes with no positive example have a monotone objective (colder
    # is always better) — T there is an artifact; keep them uncalibrated
    T = np.where(t.sum(axis=0) > 0, T, 1.0)
    return T.astype(np.float64)


def apply_temperature(y_pred: np.ndarray,
                      temperature: Union[float, np.ndarray]) -> np.ndarray:
    """probs -> temperature-scaled probs: ``sigmoid(logit(p) / T)``.
    T is a scalar or a (C,) vector broadcast over the class axis."""
    T = np.asarray(temperature, dtype=np.float64)
    if np.any(T <= 0):
        raise ValueError(f"temperature must be positive, got {temperature}")
    return _sigmoid(_logit(y_pred) / T).astype(np.float32)


def save_calibration(path, temperature: Union[float, np.ndarray], *,
                     meta: Optional[dict] = None) -> Path:
    """Write the deployable calibration JSON:
    ``{"temperature": scalar | [C floats], ...meta}`` — consumed by
    ``load_calibration`` (uit-serve --calibration, harness reports)."""
    path = Path(path)
    T = np.asarray(temperature, dtype=np.float64)
    payload = {"temperature": float(T) if T.ndim == 0 else [float(x) for x in T]}
    payload.update(meta or {})
    path.write_text(json.dumps(payload, indent=1))
    return path


def load_calibration(path) -> Union[float, np.ndarray]:
    """-> the temperature (scalar or (C,) vector) from a calibration
    JSON written by ``save_calibration``."""
    payload = json.loads(Path(path).read_text())
    T = payload["temperature"]
    if isinstance(T, list):
        arr = np.asarray(T, dtype=np.float64)
        if arr.ndim != 1 or np.any(arr <= 0):
            raise ValueError(f"bad per-class temperature vector in {path}")
        return arr
    T = float(T)
    if T <= 0:
        raise ValueError(f"bad temperature {T} in {path}")
    return T
