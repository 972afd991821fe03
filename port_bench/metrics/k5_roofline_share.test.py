"""K5 (`ops/cuda_chol.py:tri_inv`) at the traced window's largest test
bucket (the largest `n_max` of the `test` records, at its largest `batch`),
timed alone after the window on the factor of a well-conditioned batch,
its device time taken from a profiler trace of 20 calls: its bound
(benchlib/roofline.py) over that time."""

from benchlib import roofline


def read(r):
    recs = [x for x in r.records if x.get("stage") == "test"]
    if not recs or r.ctx.device.type != "cuda":
        return None
    n = int(max(x["n_max"] for x in recs))
    B = int(max(x["batch"] for x in recs if x["n_max"] == n))
    from medgp_tpu_torch.ops import cuda_chol

    K, noise, y = roofline.spd_batch(B, n, r.ctx.device)
    L, _, linvd = cuda_chol.chol_solve(K, noise, y)
    sec = roofline.traced_seconds(lambda: cuda_chol.tri_inv(L, linvd))
    bound = roofline.bound_s(B * roofline.tri_inv_flops(n), B * roofline.tri_inv_bytes(n))
    return 100.0 * bound / sec
