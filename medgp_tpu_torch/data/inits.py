"""Hyperparameter bounds in flat-theta order, and the random restart inits.

Counterpart of ``medgp_tpu/data/inits.py``: `generate` writes the bounds
file with `default_bounds`; the train stage draws its shared restart set
with `random_inits`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from medgp_tpu_torch.models.params import (
    REF_PI, KernelSpec, LMCSMSpec, SESpec, SMSpec,
)

_LEVELS = 4096  # rand() quantized to 2^12 levels (c_experiment.cpp:500-506)


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


def _draw_levels(gen: torch.Generator, shape) -> torch.Tensor:
    """Integer levels k ~ U{0, ..., 4095} (rand() quantized to 12 bits,
    c_experiment.cpp:500-506)."""
    return torch.randint(0, _LEVELS, shape, generator=gen)


def _quantized_uniform(gen, lb, ub, shape) -> torch.Tensor:
    """lb + (k + 1) (ub - lb) / 4096, float32."""
    k = _draw_levels(gen, shape)
    return lb + (k + 1).to(torch.float32) * (ub - lb) / _LEVELS


def random_inits(
    seed: int, spec: KernelSpec, bounds: HypBounds, n_inits: int
) -> torch.Tensor:
    """(n_inits, H) float32 initial flat thetas on the CPU, drawn from a
    `torch.Generator` seeded with `seed` (the experiment's random_seed).

    The distributions are the reference's (c_experiment.cpp:532-564), not
    its draws, and not JAX's (another generator): each hyper is a 12-bit
    quantized uniform over [lb, ub], transformed per block. LMC-SM:
        lik (D): log(u); A (QDR): 0.9/sqrt(Q R) u; mu (Q): log(1/u);
        v (Q): log(1/(2 pi u)); kappa (QD): log(0.1/Q u)."""
    gen = torch.Generator().manual_seed(int(seed))
    H = spec.n_hyp
    lb = torch.as_tensor(np.asarray(bounds.lb, np.float32))[None, :]
    ub = torch.as_tensor(np.asarray(bounds.ub, np.float32))[None, :]
    u = _quantized_uniform(gen, lb, ub, (n_inits, H))
    if isinstance(spec, LMCSMSpec):
        Q, D, R = spec.Q, spec.D, spec.R
        a_hi = spec.n_lik + Q * D * R
        mu_hi = a_hi + Q
        v_hi = mu_hi + Q
        # the A scale in float32, as the JAX package rounds it
        a_scale = 0.9 / torch.sqrt(torch.tensor(float(Q * R)))
        return torch.cat([
            torch.log(u[:, : spec.n_lik]),
            a_scale * u[:, spec.n_lik : a_hi],
            torch.log(1.0 / u[:, a_hi:mu_hi]),
            torch.log(1.0 / (2.0 * REF_PI * u[:, mu_hi:v_hi])),
            torch.log(0.1 / Q * u[:, v_hi:]),
        ], dim=1)
    if isinstance(spec, SESpec):
        return torch.log(u)
    if isinstance(spec, SMSpec):
        Q = spec.Q
        return torch.cat([
            torch.log(u[:, :1]),
            torch.log(u[:, 1 : 1 + Q] / Q),
            torch.log(1.0 / u[:, 1 + Q : 1 + 2 * Q]),
            torch.log(1.0 / (2.0 * REF_PI * u[:, 1 + 2 * Q :])),
        ], dim=1)
    raise TypeError(f"unsupported spec {spec!r}")
