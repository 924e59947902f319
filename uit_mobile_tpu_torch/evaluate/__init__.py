from .metrics import ALL_EVAL_METRICS, average_precision, compute_metrics, gsc_accuracy
from .calibration import (
    apply_temperature,
    ece,
    fit_temperature,
    load_calibration,
    reliability,
    save_calibration,
)
from .events import (
    EventScorer,
    event_based_scores,
    extract_events,
    load_thresholds,
    median_filter_probs,
    per_class_thresholds,
    save_thresholds,
)
from .harness import Evaluator

__all__ = [
    "ALL_EVAL_METRICS", "average_precision", "compute_metrics", "gsc_accuracy", "Evaluator",
    "EventScorer", "event_based_scores", "extract_events", "median_filter_probs",
    "per_class_thresholds", "save_thresholds", "load_thresholds",
    "ece", "reliability", "fit_temperature", "apply_temperature",
    "save_calibration", "load_calibration",
]
