"""K3 (`ops/cuda_chol.py:chol_solve`) on the large patient's diagonal
blocks over the traced window's own launches: the bound
(benchlib/roofline.py) of the systems the window's `train_large` records
count (`k3.systems`, each at the record's `block_rows`), over the device
seconds of `chol_solve_kernel` in the window's trace. None where the
records carry no K3 counter or the kernel is not among the trace's
largest operations."""

from benchlib import records, roofline


def read(r):
    recs = records.stage(r, "train_large")
    if records.total(recs, "k3.systems") is None:
        return None
    bound = sum(roofline.bound_s(x["k3.systems"] * roofline.chol_solve_flops(x["block_rows"]),
                                 x["k3.systems"] * roofline.chol_solve_bytes(x["block_rows"]))
                for x in recs)
    return records.share(bound, records.device_seconds(r, "chol_solve_kernel"))
