"""K3 (`ops/cuda_chol.py:chol_solve`) over the traced train window's own
launches: the bound (benchlib/roofline.py) of the systems that the
window's `train` records count (`k3.systems`, each at its bucket's padded
length `n_max`), over the device seconds of `chol_solve_kernel` in the
window's trace. None where the records carry no K3 counter or the kernel
is not among the trace's largest operations."""

from benchlib import records


def read(r):
    return records.k3_window_roofline_share(r, "train")
