"""Hyperparameter bounds in flat-theta order.

Counterpart of ``medgp_tpu/data/inits.py``, ported as far as the test stage
needs: `generate` writes the bounds file with `default_bounds`. The random
restart inits come with the training slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, SESpec, SMSpec


class HypBounds(NamedTuple):
    lb: np.ndarray  # (H,) float32
    ub: np.ndarray  # (H,) float32


def default_bounds(spec: KernelSpec, opt_config: dict | None = None) -> HypBounds:
    """Bounds from an opt-config dict (keys as in scripts/opt_prior*.json:
    lower/upper_bound_{noise,a,period,lengthscale,lambda,scale}); float32
    like the JAX package's, so the written file is byte-identical."""
    c = dict(
        lower_bound_noise=0.15, upper_bound_noise=0.4,
        lower_bound_a=-1.5, upper_bound_a=1.5,
        lower_bound_period=12.0, upper_bound_period=72.0,
        lower_bound_lengthscale=6.0, upper_bound_lengthscale=72.0,
        lower_bound_lambda=0.1, upper_bound_lambda=0.5,
        lower_bound_scale=0.1, upper_bound_scale=1.5,
    )
    if opt_config:
        c.update({k: v for k, v in opt_config.items() if k in c})

    if isinstance(spec, LMCSMSpec):
        Q, D, R = spec.Q, spec.D, spec.R
        blocks = [
            ("noise", D), ("a", Q * D * R), ("period", Q),
            ("lengthscale", Q), ("lambda", Q * D),
        ]
    elif isinstance(spec, SESpec):
        blocks = [("noise", 1), ("lengthscale", 1), ("scale", 1)]
    elif isinstance(spec, SMSpec):
        Q = spec.Q
        blocks = [("noise", 1), ("scale", Q), ("period", Q), ("lengthscale", Q)]
    else:
        raise TypeError(f"unsupported spec {spec!r}")
    lbs, ubs = [], []
    for name, n in blocks:
        lbs += [c[f"lower_bound_{name}"]] * n
        ubs += [c[f"upper_bound_{name}"]] * n
    return HypBounds(
        lb=np.asarray(lbs, np.float32), ub=np.asarray(ubs, np.float32)
    )
