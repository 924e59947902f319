"""mfu.<cell kind>: the logical FLOPs of the window's work
(``counts/flops.py``) over its seconds, as a % of the card's dense bf16
peak. One reader for every ``mfu.*`` metric (``harness.metric_reader``)."""

from ..counts.flops import PEAK_FLOPS


def read(run):
    if not run.get("flops"):
        return None
    return 100.0 * run["flops"] / run["window_s"] / PEAK_FLOPS
