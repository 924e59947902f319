from .metrics import ALL_EVAL_METRICS, average_precision, compute_metrics

__all__ = ["ALL_EVAL_METRICS", "average_precision", "compute_metrics"]
