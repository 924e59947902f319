"""Event-level SED: post-processing + collar-based event scoring, a copy of
``uit_mobile_tpu/evaluate/events.py`` (numpy, scipy optional, host-side).

Turns framewise per-segment probabilities (``models.apply_framewise``)
into discrete ``(class, onset, offset)`` events — median-filter
smoothing, thresholding, gap merging, minimum-duration pruning — and
scores them against reference event intervals with onset/offset collar
matching (the DCASE-style event-based F1 popularized by sed_eval,
re-derived here from the published definition; no sed_eval dependency).

The reference (RicherMans/UIT_Mobile) has no SED capability at all — its
dm head computes per-timestep probabilities (models/uit.py:405-412) and
immediately averages them away. This module completes the strong-label
round trip (train/sed.py -> evaluate/harness.strong) at the EVENT level,
one step beyond the segment-F1 scoring in evaluate/metrics.py.

All inputs/outputs are host-side numpy: event extraction is control-flow
heavy (variable-length runs) and runs once per clip on tiny arrays, so it
stays off the device by design. Segment times arrive as float64 and are
never downcast (see models.uit.framewise_times for why).
"""

from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

Event = Tuple[int, float, float]  # (class_index, onset_s, offset_s)

try:  # optional: min-onset-distance tie-break among maximum matchings
    from scipy.optimize import linear_sum_assignment as _linear_sum_assignment
except Exception:  # pragma: no cover - scipy absent
    _linear_sum_assignment = None


def _max_bipartite_matching(admissible) -> set:
    """Maximum-cardinality bipartite matching via augmenting paths
    (Kuhn's algorithm) on a preds x refs admissibility matrix — the
    scipy-free fallback; event counts per clip/class are tiny. Returns
    the set of matched pred indices."""
    n_refs = len(admissible[0]) if admissible else 0
    match_of_ref = [-1] * n_refs

    def augment(i, seen):
        for j in range(n_refs):
            if admissible[i][j] and not seen[j]:
                seen[j] = True
                if match_of_ref[j] < 0 or augment(match_of_ref[j], seen):
                    match_of_ref[j] = i
                    return True
        return False

    for i in range(len(admissible)):
        augment(i, [False] * n_refs)
    return {i for i in match_of_ref if i >= 0}


def median_filter_probs(probs: np.ndarray, kernel_size: int) -> np.ndarray:
    """Per-class median filter along the segment axis (odd kernel,
    edge-replicated padding — the standard SED smoothing that suppresses
    single-segment flickers before thresholding).

    probs: (..., S, C); filtering runs over S independently per class.
    kernel_size=1 is the identity.
    """
    p = np.asarray(probs)
    if kernel_size <= 1 or p.shape[-2] == 0:
        return p  # identity; S=0 would crash sliding_window_view
    if kernel_size % 2 != 1:
        raise ValueError(f"median kernel must be odd, got {kernel_size}")
    pad = kernel_size // 2
    padded = np.concatenate(
        [np.repeat(p[..., :1, :], pad, axis=-2), p,
         np.repeat(p[..., -1:, :], pad, axis=-2)],
        axis=-2,
    )
    win = np.lib.stride_tricks.sliding_window_view(padded, kernel_size, axis=-2)
    return np.median(win, axis=-1)


def per_class_thresholds(threshold, num_classes: int,
                         default: float = 0.5) -> np.ndarray:
    """Resolve a threshold spec to a (num_classes,) float vector.

    Accepted forms, everywhere a decision threshold is taken:
    - scalar: one operating point for every class;
    - array-like of shape (num_classes,): explicit per-class vector;
    - mapping {class_index: threshold}: listed classes use their value,
      the rest use the mapping's ``'default'`` entry (else ``default``).
      This is the shape the strong-eval sweep emits
      (``_best_event_threshold_per_class``) and ``save_thresholds``
      round-trips, so tuned operating points flow eval -> deploy.
    """
    if isinstance(threshold, dict):
        fill = float(threshold.get("default", default))
        vec = np.full(num_classes, fill, dtype=np.float64)
        for c, th in threshold.items():
            if c == "default":
                continue
            c = int(c)
            if not 0 <= c < num_classes:
                raise ValueError(
                    f"threshold for class {c} out of range for "
                    f"{num_classes}-way output")
            vec[c] = float(th)
        return vec
    vec = np.asarray(threshold, dtype=np.float64)
    if vec.ndim == 0:
        return np.full(num_classes, float(vec), dtype=np.float64)
    if vec.shape != (num_classes,):
        raise ValueError(
            f"per-class threshold vector has shape {vec.shape}, "
            f"expected ({num_classes},)")
    return vec


def save_thresholds(path, per_class: dict, default: float = 0.5):
    """Write a per-class threshold file (JSON: {'default': .., 'per_class':
    {class: threshold}}) — the deploy artifact of ``Evaluator.strong``'s
    sweep; consumed by ``load_thresholds``."""
    import json
    from pathlib import Path

    payload = {"default": float(default),
               "per_class": {str(int(c)): float(t)
                             for c, t in sorted(per_class.items())}}
    Path(path).write_text(json.dumps(payload, indent=1) + "\n")


def load_thresholds(path) -> dict:
    """Read a ``save_thresholds`` file back into the mapping form
    ``per_class_thresholds`` (and every threshold= parameter) accepts."""
    import json
    from pathlib import Path

    payload = json.loads(Path(path).read_text())
    spec = {int(c): float(t)
            for c, t in payload.get("per_class", {}).items()}
    spec["default"] = float(payload.get("default", 0.5))
    return spec


def extract_events(times: np.ndarray, probs: np.ndarray, *,
                   threshold=0.5, median_kernel: int = 1,
                   min_duration: float = 0.0, merge_gap: float = 0.0,
                   classes: Iterable[int] | None = None) -> List[Event]:
    """Framewise probabilities -> discrete events for one clip.

    times: (S, 2) [start, end) seconds per segment (may be unsorted and
    overlapping — the long-clip tail window overlaps the previous one by
    the crop rule, see models.uit.framewise_times).
    probs: (S, C).
    threshold: scalar, (C,) vector, or {class: th} mapping — see
    ``per_class_thresholds`` (per-class operating points are the
    psds_eval/DCASE deployment practice).

    Pipeline per class: median filter -> threshold -> contiguous/overlap
    run merging (runs separated by <= merge_gap seconds fuse) -> drop
    runs shorter than min_duration. Returns events sorted by onset.
    """
    times = np.asarray(times, dtype=np.float64)
    probs = np.asarray(probs)
    if times.shape != (probs.shape[0], 2):
        raise ValueError(f"times {times.shape} do not match probs {probs.shape}")
    order = np.argsort(times[:, 0], kind="stable")
    th_vec = per_class_thresholds(threshold, probs.shape[1])
    # filter AFTER the time sort: dm-mode framewise_times emits
    # window-major rows where the tail window rewinds behind the previous
    # one — smoothing in raw index order would mix segments up to a full
    # window apart in time at that boundary
    active = median_filter_probs(probs[order], median_kernel) >= th_vec[None, :]
    t = times[order]
    eps = 1e-9
    events: List[Event] = []
    for c in (range(active.shape[1]) if classes is None else classes):
        runs: List[List[float]] = []
        for i in np.flatnonzero(active[:, int(c)]):
            s, e = t[i]
            if runs and s <= runs[-1][1] + merge_gap + eps:
                runs[-1][1] = max(runs[-1][1], e)
            else:
                runs.append([s, e])
        events.extend(
            (int(c), float(on), float(off))
            for on, off in runs
            if off - on >= min_duration - eps
        )
    events.sort(key=lambda ev: (ev[1], ev[2], ev[0]))
    return events


class EventScorer:
    """Accumulates matched event counts across clips.

    Matching per clip per class, two criteria:
    - ``criterion='collar'`` (default, DCASE event-based semantics): a
      predicted event matches a reference when |onset difference| <=
      t_collar and — unless offset_condition=False — |offset difference|
      <= max(t_collar, offset_collar_rate * reference duration).
    - ``criterion='intersection'`` (PSDS-style DTC/GTC): a prediction
      matches when intersection/prediction_duration >= dtc AND
      intersection/reference_duration >= gtc — tolerant of sloppy
      boundaries on long events where a fixed collar is punitive.

    Each reference event consumes at most one prediction; the assignment
    is an OPTIMAL bipartite matching (maximum cardinality, minimal total
    onset distance among maximum matchings, via Hungarian) — a greedy
    nearest-onset pass can undercount TPs when one prediction is the only
    admissible match for a later reference (event counts per clip/class
    are tiny, so Hungarian is essentially free).

    Use: one ``add_clip(pred, ref)`` call per clip (events never match
    across clip boundaries), then ``scores()``.
    """

    def __init__(self, t_collar: float = 0.2, offset_collar_rate: float = 0.2,
                 offset_condition: bool = True, criterion: str = "collar",
                 dtc: float = 0.5, gtc: float = 0.5, cttc: float | None = None,
                 count_cross_triggers: bool = False):
        if criterion not in ("collar", "intersection"):
            raise ValueError(f"unknown criterion {criterion!r}")
        self.t_collar = float(t_collar)
        self.rate = float(offset_collar_rate)
        self.offset_condition = offset_condition
        self.criterion = criterion
        self.dtc = float(dtc)
        self.gtc = float(gtc)
        # cross-trigger tolerance (PSDS CTTC): an UNMATCHED prediction of
        # class c cross-triggers class c' when some class-c' reference
        # covers >= cttc of the prediction's duration. Defaults to 0.3 —
        # psds_eval's cttc_threshold default, an INDEPENDENT parameter
        # (not tied to dtc): reproducing psds_eval reference numbers
        # needs 0.3 unless the caller overrides.
        self.cttc = float(0.3 if cttc is None else cttc)
        self.count_cross_triggers = bool(count_cross_triggers)
        self.tp: Counter = Counter()
        self.fp: Counter = Counter()
        self.fn: Counter = Counter()
        # (pred_class, other_class) -> cross-trigger count; per-class
        # reference-event total duration in SECONDS (the alpha_ct
        # normalizer) rides along when counting is enabled
        self.ct: Counter = Counter()
        self.ref_duration: Counter = Counter()

    def _matches(self, pred: Event, ref: Event) -> bool:
        _, on_p, off_p = pred
        _, on_r, off_r = ref
        if self.criterion == "intersection":
            eps = 1e-9
            inter = min(off_p, off_r) - max(on_p, on_r)
            return (inter / max(off_p - on_p, eps) >= self.dtc
                    and inter / max(off_r - on_r, eps) >= self.gtc)
        if abs(on_p - on_r) > self.t_collar:
            return False
        if not self.offset_condition:
            return True
        return abs(off_p - off_r) <= max(self.t_collar, self.rate * (off_r - on_r))

    def add_clip(self, pred_events: Sequence[Event], ref_events: Sequence[Event]):
        by_cls_p: Dict[int, list] = defaultdict(list)
        by_cls_r: Dict[int, list] = defaultdict(list)
        for ev in pred_events:
            by_cls_p[int(ev[0])].append((int(ev[0]), float(ev[1]), float(ev[2])))
        for ev in ref_events:
            by_cls_r[int(ev[0])].append((int(ev[0]), float(ev[1]), float(ev[2])))
        for c in set(by_cls_p) | set(by_cls_r):
            preds = sorted(by_cls_p.get(c, ()), key=lambda e: e[1])
            refs = sorted(by_cls_r.get(c, ()), key=lambda e: e[1])
            matched = self._match_preds(preds, refs)
            tp = len(matched)
            self.tp[c] += tp
            self.fn[c] += len(refs) - tp
            self.fp[c] += len(preds) - tp
            if self.count_cross_triggers:
                eps = 1e-9
                for i, (_, on_p, off_p) in enumerate(preds):
                    if i in matched:
                        continue
                    dur_p = max(off_p - on_p, eps)
                    for c2, refs2 in by_cls_r.items():
                        if c2 == c:
                            continue
                        if any(
                            (min(off_p, off_r) - max(on_p, on_r)) / dur_p
                            >= self.cttc
                            for _, on_r, off_r in refs2
                        ):
                            self.ct[(c, c2)] += 1
        if self.count_cross_triggers:
            for c, on_r, off_r in ((int(e[0]), float(e[1]), float(e[2]))
                                   for e in ref_events):
                self.ref_duration[c] += off_r - on_r

    def _match_preds(self, preds: list, refs: list) -> set:
        """Maximum-cardinality matching between admissible (pred, ref)
        pairs; returns the set of MATCHED pred indices (the complement is
        the FP set — what cross-trigger counting consumes). With scipy
        present, Hungarian on a cost matrix where inadmissible pairs cost
        more than any sum of admissible ones — minimizing total cost
        first maximizes the number of admissible matches and, among
        maximum matchings, minimizes total onset distance. Without scipy,
        a pure-python augmenting-path matching gives the same (maximum)
        cardinality, dropping only the onset-distance tie-break (counts
        are unchanged)."""
        if not preds or not refs:
            return set()
        admissible = [[self._matches(p, r) for r in refs] for p in preds]
        if _linear_sum_assignment is not None:
            cost = np.empty((len(preds), len(refs)))
            spans = [abs(p[1] - r[1]) for p in preds for r in refs]
            big = max(spans) * (len(preds) + len(refs) + 1) + 1.0
            for i, p in enumerate(preds):
                for j, r in enumerate(refs):
                    cost[i, j] = (abs(p[1] - r[1]) if admissible[i][j]
                                  else big)
            rows, cols = _linear_sum_assignment(cost)
            return {int(i) for i, j in zip(rows, cols) if cost[i, j] < big}
        return _max_bipartite_matching(admissible)

    @staticmethod
    def _prf(tp: int, fp: int, fn: int) -> Tuple[float, float, float]:
        p = tp / (tp + fp) if tp + fp else 0.0
        r = tp / (tp + fn) if tp + fn else 0.0
        f = 2 * p * r / (p + r) if p + r else 0.0
        return p, r, f

    def scores(self) -> dict:
        """Micro scores over summed counts; macro F1 over every class that
        appears in references or predictions. Per-class F1 rides along
        under an underscore key (report writers skip ``_``-prefixed)."""
        classes = sorted(set(self.tp) | set(self.fp) | set(self.fn))
        per_class = {
            c: self._prf(self.tp[c], self.fp[c], self.fn[c])[2] for c in classes
        }
        micro_p, micro_r, micro_f = self._prf(
            sum(self.tp.values()), sum(self.fp.values()), sum(self.fn.values())
        )
        return {
            "Event_Micro_F1": micro_f,
            "Event_Micro_Precision": micro_p,
            "Event_Micro_Recall": micro_r,
            "Event_Macro_F1": (
                float(np.mean(list(per_class.values()))) if per_class else 0.0
            ),
            "_event_per_class_f1": per_class,
        }


def event_based_scores(clip_pairs, *, t_collar: float = 0.2,
                       offset_collar_rate: float = 0.2,
                       offset_condition: bool = True,
                       criterion: str = "collar", dtc: float = 0.5,
                       gtc: float = 0.5) -> dict:
    """One-shot convenience over ``EventScorer``: ``clip_pairs`` is an
    iterable of (predicted_events, reference_events) per clip."""
    scorer = EventScorer(t_collar=t_collar, offset_collar_rate=offset_collar_rate,
                         offset_condition=offset_condition,
                         criterion=criterion, dtc=dtc, gtc=gtc)
    for pred, ref in clip_pairs:
        scorer.add_clip(pred, ref)
    return scorer.scores()
