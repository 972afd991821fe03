"""K3 (`ops/cuda_chol.py:chol_solve`) at the traced window's largest train
bucket (the largest `n_max` of the `train` records, at its largest
`batch`), timed alone after the window on a well-conditioned batch, its
device time taken from a profiler trace of 20 calls: its bound
(benchlib/roofline.py) over that time."""

from benchlib import roofline


def read(r):
    recs = [x for x in r.records if x.get("stage") == "train"]
    if not recs or r.ctx.device.type != "cuda":
        return None
    n = int(max(x["n_max"] for x in recs))
    B = int(max(x["batch"] for x in recs if x["n_max"] == n))
    from medgp_tpu_torch.ops import cuda_chol

    K, noise, y = roofline.spd_batch(B, n, r.ctx.device)
    sec = roofline.traced_seconds(lambda: cuda_chol.chol_solve(K, noise, y))
    bound = roofline.bound_s(B * roofline.chol_solve_flops(n), B * roofline.chol_solve_bytes(n))
    return 100.0 * bound / sec
