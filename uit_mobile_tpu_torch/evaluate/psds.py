"""PSDS — Polyphonic Sound Detection Score (Bilen et al., ICASSP 2020), a copy
of ``uit_mobile_tpu/evaluate/psds.py``.

The field-standard threshold-independent SED metric, computed over the
operating points the strong-eval sweep already produces (one model pass,
many decision thresholds): per class, an ROC of true-positive rate vs
effective false-positive RATE (FPs per hour of audio); the PSD-ROC is the
across-class mean TPR (optionally penalized by the across-class standard
deviation, ``alpha_st``) as a function of eFPR, and PSDS is its
normalized area up to ``e_max`` FPs/hour.

Event matching uses the DTC/GTC intersection criterion
(evaluate.events.EventScorer(criterion='intersection')) — the same rule
the PSDS paper defines. The cross-trigger term is supported: with
``alpha_ct > 0`` an unmatched prediction of class c that covers >= cttc
of its duration with some reference of class c' counts as a
cross-trigger CT(c, c'), and the effective FPR becomes

    eFPR_c = FP_c / T_dataset
             + alpha_ct * mean_{c' != c} CT(c, c') / T_ref(c')

with T_ref(c') the total reference-event duration of class c' (the
psds_eval normalization). Simplifications vs the reference
implementation, stated plainly:

- matching is one-to-one bipartite on a per-pair intersection test
  rather than the paper's summed-intersection DTC/GTC (evaluate.events
  docstring); the CTTC test is likewise per-reference, not summed;
- operating points come from the caller's threshold sweep rather than
  from every achievable decision surface — PSDS is monotonically
  non-decreasing in the number of sweep points, so a coarse sweep LOWER-
  bounds the true score.

The reference framework (RicherMans/UIT_Mobile) has no strong-label
evaluation at all; this extends the SED stack past segment/event F1 to
the metric DCASE task 4 reports.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Tuple

import numpy as np

OperatingPoint = Mapping[int, Tuple[int, int, int]]  # class -> (tp, fp, fn)


def roc_per_class(points: Sequence[OperatingPoint], duration_hours: float,
                  classes: Sequence[int],
                  efpr_extra: Sequence[Mapping[int, float]] | None = None,
                  ) -> Dict[int, np.ndarray]:
    """Per class: monotone ROC support (eFPR, TPR) from raw counts.

    Each operating point contributes (fp / duration_hours, tp / n_ref);
    the ROC is the non-decreasing upper envelope (cummax of TPR along
    sorted eFPR — the standard staircase construction). efpr_extra
    (parallel to points, class -> addend) shifts each point's eFPR right
    — the cross-trigger penalty term computed by ``psds``."""
    if not duration_hours > 0.0:
        raise ValueError(f"duration_hours must be positive, got {duration_hours}")
    curves = {}
    for c in classes:
        pts = []
        for k, op in enumerate(points):
            tp, fp, fn = op.get(c, (0, 0, 0))
            n_ref = tp + fn
            tpr = tp / n_ref if n_ref else 0.0
            e = fp / duration_hours
            if efpr_extra is not None:
                e += efpr_extra[k].get(c, 0.0)
            pts.append((e, tpr))
        pts.sort()
        arr = np.asarray(pts, dtype=np.float64)
        arr[:, 1] = np.maximum.accumulate(arr[:, 1])
        curves[c] = arr
    return curves


def _tpr_at(curve: np.ndarray, e: float) -> float:
    """Staircase lookup: best TPR among points with eFPR <= e."""
    sel = curve[:, 0] <= e + 1e-12
    return float(curve[sel, 1].max()) if sel.any() else 0.0


def psds(points: Sequence[OperatingPoint], *, duration_hours: float,
         alpha_st: float = 0.0, alpha_ct: float = 0.0, e_max: float = 100.0,
         ct_points: Sequence[Mapping[Tuple[int, int], int]] | None = None,
         ref_duration_hours: Mapping[int, float] | None = None) -> dict:
    """PSDS over per-threshold (tp, fp, fn) counts.

    points: one mapping per sweep threshold, class -> (tp, fp, fn) —
    exactly ``EventScorer``'s counters. Classes are those with at least
    one reference event (TPR is undefined otherwise; pure-FP classes
    still shape other classes' curves only through their own, so they
    are excluded, matching the paper).

    alpha_ct: cross-trigger penalty weight. Needs ``ct_points`` (one
    mapping per threshold, (pred_class, other_class) -> count — exactly
    ``EventScorer(count_cross_triggers=True).ct``) and
    ``ref_duration_hours`` (class -> total reference-event hours, from
    ``EventScorer.ref_duration / 3600``); each class's eFPR gains
    alpha_ct * mean over OTHER classes of CT(c, c') / T_ref(c')
    (classes without reference duration contribute nothing).

    Returns {'PSDS': float, '_psd_roc': {eFPR: eTPR}, per-class aucs}.
    """
    classes = sorted({
        c for op in points for c, (tp, fp, fn) in op.items() if tp + fn > 0
    })
    if not classes:
        return {"PSDS": 0.0, "_psd_roc": {}, "_per_class_auc": {}}
    extra = None
    if alpha_ct:
        # a silently-dropped penalty would report the unpenalized (higher)
        # score under the cross-trigger-penalized metric's name — refuse
        if ct_points is None:
            raise ValueError(
                "alpha_ct > 0 needs ct_points (per-threshold cross-trigger "
                "counts from EventScorer(count_cross_triggers=True).ct)"
            )
        if len(ct_points) != len(points):
            raise ValueError("alpha_ct needs one ct mapping per operating point")
        durs = dict(ref_duration_hours or {})
        if not any(durs.get(c, 0.0) > 0 for c in classes):
            raise ValueError(
                "alpha_ct > 0 needs ref_duration_hours with positive "
                "reference-event durations (EventScorer.ref_duration/3600) "
                "— without them every cross-trigger term is dropped"
            )
        others = {c: [c2 for c2 in classes if c2 != c and durs.get(c2, 0.0) > 0]
                  for c in classes}
        extra = [
            {
                c: alpha_ct * float(np.mean([
                    ct.get((c, c2), 0) / durs[c2] for c2 in others[c]
                ])) if others[c] else 0.0
                for c in classes
            }
            for ct in ct_points
        ]
    curves = roc_per_class(points, duration_hours, classes, efpr_extra=extra)

    # support: every eFPR knot below e_max, plus the endpoints
    knots = sorted({0.0, e_max} | {
        float(e) for arr in curves.values() for e in arr[:, 0] if e < e_max
    })
    roc = {}
    for e in knots:
        tprs = np.asarray([_tpr_at(curves[c], e) for c in classes])
        roc[e] = float(tprs.mean() - alpha_st * tprs.std())
    # right-continuous staircase integral over [0, e_max]
    area = 0.0
    for (e0, v), e1 in zip(roc.items(), list(roc)[1:] + [e_max]):
        area += max(0.0, v) * (e1 - e0)
    per_class_auc = {
        c: sum(
            _tpr_at(curves[c], e0) * (e1 - e0)
            for e0, e1 in zip(knots, knots[1:] + [e_max])
        ) / e_max
        for c in classes
    }
    return {
        "PSDS": area / e_max,
        "_psd_roc": roc,
        "_per_class_auc": per_class_auc,
    }
