"""idle.<cell kind>: % of the traced stretch with no kernel, memcpy or memset
on the card (torch.profiler's device timeline). One reader for every
``idle.*`` metric (``harness.metric_reader``)."""


def read(run):
    t = run.get("trace")
    if not t or not t["window_s"] or not t["busy_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
