"""The online loop's share of the card's fp32 peak over the traced test
window: the operations of the systems that the window's `test` records
count for K1-K5 (`<k>.systems`, each at its bucket's padded length
`n_max`; K4 holds K5's work inside its launch), counted by
benchlib/roofline.py, over window seconds x 67 TFLOP/s. None where the
records carry no kernel counters."""

from benchlib import records, roofline


def read(r):
    recs = records.stage(r, "test")
    Q = r.ctx.config["Q"]
    ops = dict(
        k1=lambda n: roofline.gram_flops(n, Q), k2=lambda n: roofline.gram_bwd_flops(n, Q),
        k3=roofline.chol_solve_flops, k4=roofline.qmat_flops, k5=roofline.tri_inv_flops,
    )
    parts = [records.total(recs, k + ".systems", lambda x, f=f: f(x["n_max"]))
             for k, f in ops.items()]
    if None in parts:
        return None
    return records.share(sum(parts), r.trace["window_s"] * roofline.PEAK_FP32)
