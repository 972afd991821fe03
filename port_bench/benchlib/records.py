"""Sums over the program's records of the traced window, for the metrics
that read its spans and counters.

Each `train` / `test` record of log/metrics.jsonl (parallel/runner.py)
carries what the program's table of spans and counters
(medgp_tpu_torch/utils/metrics.py) gained in its bucket: `span_s.<span>`,
`self_s.<span>`, `calls.<span>`, `<k>.systems`, `<k>.launches` (k1..k5)
and `k3.retry_systems`. A program without that table writes none of these
fields, and every sum here is then None.
"""

from __future__ import annotations

from benchlib import roofline


def stage(r, name: str) -> list:
    """The window's records of stage `name` ("train" or "test")."""
    return [x for x in r.records if x.get("stage") == name]


def total(recs, field: str, weight=None):
    """Sum over `recs` of `field` (times `weight(record)` where given);
    None if there is no record or one lacks the field."""
    if not recs or any(field not in x for x in recs):
        return None
    return sum(x[field] * (1.0 if weight is None else weight(x)) for x in recs)


def share(num, den):
    """100 num / den, or None where either is missing or den is not
    positive."""
    if num is None or den is None or den <= 0:
        return None
    return 100.0 * num / den


def device_seconds(r, kernel: str):
    """Device seconds of the operations whose name holds `kernel` among the
    trace's largest (`device_ops`), or None if none is listed."""
    hits = [s for name, s in r.trace.get("device_ops", []) if kernel in name]
    return sum(hits) if hits else None


def k3_window_roofline_share(r, name: str):
    """K3's share of its roofline over the window's own launches: the
    bound of each record's `k3.systems` at its padded length `n_max`,
    summed over the window's records of stage `name`, over the device
    seconds of `chol_solve_kernel`."""
    recs = stage(r, name)
    if total(recs, "k3.systems") is None:
        return None
    bound = sum(roofline.bound_s(x["k3.systems"] * roofline.chol_solve_flops(x["n_max"]),
                                 x["k3.systems"] * roofline.chol_solve_bytes(x["n_max"]))
                for x in recs)
    return share(bound, device_seconds(r, "chol_solve_kernel"))
