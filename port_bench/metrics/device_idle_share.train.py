"""Share of the traced train window in which no operation ran on the
device: 100 (1 - busy / window), busy the union of the device events'
intervals (benchlib/trace.py)."""


def read(r):
    w = r.trace["window_s"]
    return 100.0 * (1.0 - r.trace["busy_s"] / w) if w > 0 else None
