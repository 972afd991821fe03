"""The train step's share of the card's fp32 peak over the traced window:
the operations of every objective+gradient evaluation the window's `train`
records count (`evaluations`, at the bucket's padded length `n_max`) and of
the restart screen (restarts x `batch` value-only NLMLs at `n_max`),
counted by benchlib/roofline.py, over window seconds x 67 TFLOP/s."""

from benchlib import roofline


def read(r):
    recs = [x for x in r.records if x.get("stage") == "train"]
    if not recs or r.trace["window_s"] <= 0:
        return None
    Q, S = r.ctx.config["Q"], r.ctx.config["random_init_num"]
    flops = sum(
        x["evaluations"] * roofline.objective_grad_flops(x["n_max"], Q)
        + S * x["batch"] * roofline.value_flops(x["n_max"], Q)
        for x in recs
    )
    return 100.0 * flops / (r.trace["window_s"] * roofline.PEAK_FP32)
