"""The table of peaks and the operation and byte counts of the program's
kernels, frozen from the counts `chip_smoke.py` states, and a timer of a
kernel alone by the device's trace.

Peaks: one H100 SXM, NVIDIA's data sheet, dense rates at the 700 W limit:
67 TFLOP/s fp32 outside the tensor cores (the program's precision, TF32
off), 3.35 TB/s of device memory. A kernel's bound is the larger of its
operations over the fp32 peak and its bytes (each input read once, each
output written once, counted from the shapes) over the memory peak.

Per system of n observations, Q mixture components:
  K1 gram forward   9 Q n (n + 1) / 2 operations (distinct entries);
  K2 gram backward  20 Q n^2;
  K3 chol_solve     n^3 / 3 + 4 n^2, bytes 4 (2 n^2 + 4 n + 32 n);
  K4 qmat           2 n^3 / 3, bytes 4 (2 n^2 + 33 n + 1);
  K5 tri_inv        n^3 / 3, bytes 4 (2 n^2 + 32 n).
An objective and its gradient is K1 + K3 + K4 + K2; a value alone (the
restart screen) K1 + K3.
"""

from __future__ import annotations

import torch

PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
GRAM_OPS = 9
GRAM_BWD_OPS = 20


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FP32, nbytes / PEAK_BYTES)


def gram_flops(n, Q):
    return GRAM_OPS * Q * n * (n + 1) / 2


def gram_bwd_flops(n, Q):
    return GRAM_BWD_OPS * Q * n * n


def chol_solve_flops(n):
    return n ** 3 / 3 + 4 * n * n


def chol_solve_bytes(n):
    return 4 * (2 * n * n + 4 * n + 32 * n)


def qmat_flops(n):
    return 2 * n ** 3 / 3


def tri_inv_flops(n):
    return n ** 3 / 3


def tri_inv_bytes(n):
    return 4 * (2 * n * n + 32 * n)


def objective_grad_flops(n, Q):
    """One objective and gradient evaluation of one patient at length n."""
    return gram_flops(n, Q) + chol_solve_flops(n) + qmat_flops(n) + gram_bwd_flops(n, Q)


def value_flops(n, Q):
    """One value-only NLML (the restart screen) at length n."""
    return gram_flops(n, Q) + chol_solve_flops(n)


def traced_seconds(fn, reps: int = 20, warm: int = 3) -> float:
    """Device seconds of one `fn()` call: after `warm` calls, `reps` calls
    under the profiler (benchlib/trace.py), the union of the device
    events' intervals over them, per call."""
    from benchlib.trace import Trace

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    with Trace() as tr:
        with tr.window():
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    return tr.readings()["busy_s"] / reps


def spd_batch(B: int, n: int, device, seed: int = 0):
    """A well-conditioned SPD batch (K, noise, y), float32, for timing."""
    g = torch.Generator(device=device).manual_seed(seed)
    X = torch.randn((B, n, n), generator=g, device=device) / n ** 0.5
    K = X @ X.mT + 0.5 * torch.eye(n, device=device)
    noise = torch.full((B, n), 0.1, device=device)
    y = torch.randn((B, n), generator=g, device=device)
    return K.contiguous(), noise, y
