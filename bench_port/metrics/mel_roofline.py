"""mel_roofline.<cell kind>: the mel kernel's share of its roofline, %: the
launches' least time (``counts.flops.mel_bound_s`` of the cell's launch
shape) over their summed device time in the trace. One reader for every
``mel_roofline.*`` metric (``harness.metric_reader``)."""


def read(run):
    t, bound = run.get("trace"), run.get("mel_bound_s")
    if not t or bound is None:
        return None
    mel = [(n, s) for name, (n, s) in t["ops"].items() if "mel_kernel" in name]
    launches, seconds = sum(n for n, _ in mel), sum(s for _, s in mel)
    if not launches or not seconds:
        return None
    return 100.0 * launches * bound / seconds
