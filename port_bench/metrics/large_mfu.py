"""The large-patient window's share of the card's fp32 peak: the model's
operations of the value+gradient calls and the screen values that the
window's `train_large` records count (`large.evaluations`,
`large.screen_values`), over window seconds x 67 TFLOP/s. None where the
records carry no such counter.

The operations are counted from the padded length n = blocks x
block_rows of a record alone, as the dense objective's counts of
benchlib/roofline.py: a value is the gram and the factorization with its
solve (n^3/3 + 4 n^2); a value and its gradient add the inverse's
2 n^3/3 and the gram's backward. The count does not depend on the block
width b: the blocked factorization walks only the lower block triangle
and its backward forms one block column of K^-1 at a time, but the work
it stands for is the same whatever implements it."""

from benchlib import records, roofline


def record_flops(rec, Q):
    """Operations of the evaluations and screen values a `train_large`
    record counts, or None where it lacks them."""
    if "large.evaluations" not in rec or "large.screen_values" not in rec:
        return None
    n = rec["blocks"] * rec["block_rows"]
    return (rec["large.evaluations"] * roofline.objective_grad_flops(n, Q)
            + rec["large.screen_values"] * roofline.value_flops(n, Q))


def read(r):
    recs = records.stage(r, "train_large")
    if not recs or r.trace["window_s"] <= 0:
        return None
    flops = [record_flops(x, r.ctx.config["Q"]) for x in recs]
    if any(f is None for f in flops):
        return None
    return 100.0 * sum(flops) / (r.trace["window_s"] * roofline.PEAK_FP32)
