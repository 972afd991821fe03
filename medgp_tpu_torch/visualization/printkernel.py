"""Human-readable kernel summaries (period / lengthscale / coregional range).

Counterpart of ``medgp_tpu/visualization/printkernel.py`` on the port's
kernel specs (host numpy). The interpretability layer of the reference
(medgpc/visualization/printkernel.py:5-44): converts hyper vectors back to
clinical-scale quantities — period = 1/mu hours, lengthscale =
1/(2*pi*sqrt(v2)) hours, and per-component B ranges.
"""

from __future__ import annotations

import numpy as np

from medgp_tpu_torch.models.params import LMCSMSpec, SESpec, SMSpec


def kernel_summary(spec, theta: np.ndarray) -> list[dict]:
    """Structured per-component summary; print with `print_kernel_info`."""
    theta = np.asarray(theta, np.float64)
    if isinstance(spec, SESpec):
        return [
            dict(
                component=0,
                scalefactor=float(np.exp(theta[2])),
                lengthscale=float(np.exp(theta[1])),
                noise_std=float(np.exp(theta[0])),
            )
        ]
    if isinstance(spec, SMSpec):
        Q = spec.Q
        out = []
        for q in range(Q):
            mu = np.exp(theta[1 + Q + q])
            v2 = np.exp(2 * theta[1 + 2 * Q + q])
            out.append(
                dict(
                    component=q,
                    weight=float(np.exp(theta[1 + q])),
                    period=float(1.0 / mu),
                    lengthscale=float(1.0 / (2 * np.pi * np.sqrt(v2))),
                )
            )
        return out
    if isinstance(spec, LMCSMSpec):
        Q, D, R = spec.Q, spec.D, spec.R
        A = theta[D : D + Q * D * R].reshape(Q, D, R)
        kap = np.exp(theta[D + Q * (D * R + 2) :]).reshape(Q, D)
        out = []
        for q in range(Q):
            mu = np.exp(theta[D + Q * D * R + q])
            v2 = np.exp(2 * theta[D + Q * (D * R + 1) + q])
            B = A[q] @ A[q].T + np.diag(kap[q])
            out.append(
                dict(
                    component=q,
                    period=float(1.0 / mu),
                    lengthscale=float(1.0 / (2 * np.pi * np.sqrt(v2))),
                    B_max=float(B.max()),
                    B_min=float(B.min()),
                    B_sparsity_pct=float(
                        100.0 * np.mean(np.abs(B) < 1e-3)
                    ),
                )
            )
        return out
    raise TypeError(f"unsupported spec {spec!r}")


def print_kernel_info(spec, theta: np.ndarray) -> None:
    rows = kernel_summary(spec, theta)
    if isinstance(spec, LMCSMSpec):
        print("LMC-SM kernel Q={}".format(spec.Q))
        print("q,\t period,\t lengthscale,\t max(Bq),\t min(Bq)")
        for r in rows:
            print(
                "{},\t {:6.4f},\t {:6.4f},\t {:6.4f},\t {:6.4f}".format(
                    r["component"], r["period"], r["lengthscale"],
                    r["B_max"], r["B_min"],
                )
            )
    elif isinstance(spec, SMSpec):
        print("SM kernel Q={}".format(spec.Q))
        print("q,\t period,\t lengthscale")
        for r in rows:
            print(
                "{},\t {:6.4f},\t {:6.4f}".format(
                    r["component"], r["period"], r["lengthscale"]
                )
            )
    else:
        r = rows[0]
        print(
            "SE kernel: scalefactor={:6.4f},\t lengthscale={:6.4f}".format(
                r["scalefactor"], r["lengthscale"]
            )
        )
