"""Summaries of the per-row gaps a check computes, for the calibration's
readings."""

import numpy as np


def summary(values) -> dict:
    v = np.asarray(values, np.float64)
    if v.size == 0:
        return dict(n=0)
    q = np.quantile(v, [0.5, 0.75, 0.9, 0.99])
    return dict(n=int(v.size), q50=float(q[0]), q75=float(q[1]), q90=float(q[2]),
                q99=float(q[3]), max=float(v.max()))
