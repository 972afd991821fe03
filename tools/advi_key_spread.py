#!/usr/bin/env python3
"""How far the JAX package's ADVI fit moves from key to key.

    JAX_PLATFORMS=cpu python3 tools/advi_key_spread.py

ADVI (medgp_tpu/infer/vi.py) returns Adam's last iterate, which jitters
around the optimum. This measures that jitter in the JAX package itself,
the yardstick for the port's ADVI tests (tests/test_torch_vi.py):

  * the diagonal Gaussian of tests/test_vi.py:15-38 (1,500 steps, 8
    draws, rate 0.05) over keys 0..9: each fit's largest |mean - mu| and
    how many fits fall within that test's 0.1;
  * the GP patient of tests/test_torch_vi.py (LMC-SM(1, 2, 1), the same
    MAP start, the N(0, 1) prior, 400 steps, 4 draws, rate 0.02) over 8
    keys: the spread (std over keys) of each coordinate's variational
    mean, over the fitted posterior std.

Prints one JSON line.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from medgp_tpu.infer import vi as jvi  # noqa: E402
from tests import test_torch_hmc as T  # noqa: E402


def gaussian_errors(keys=10):
    mu = jnp.asarray([1.0, -2.0, 0.5])
    sigma = jnp.asarray([0.5, 2.0, 1.0])

    def pg(x):
        return jnp.sum(0.5 * ((x - mu) / sigma) ** 2), (x - mu) / sigma**2

    fit = jax.jit(lambda key: jvi.advi_fit(
        pg, jnp.zeros(3), key, num_steps=1500, num_mc=8, learning_rate=0.05).mean)
    return [float(jnp.max(jnp.abs(fit(jax.random.key(k)) - mu))) for k in range(keys)]


def gp_spread(fits=8):
    jspec, spec = T.jparams.LMCSMSpec(1, 2, 1), T.tparams.LMCSMSpec(1, 2, 1)
    arrs = T.gp_patient(81, spec)
    jp, tp = T.normal_priors(spec.n_hyp)
    theta_map = T.map_start(spec, arrs, tp, 82)
    res = jax.jit(jax.vmap(
        lambda key: jvi.vi_patient(jspec, T.jdata(arrs), jnp.asarray(theta_map), key,
                                   prior=jp, num_steps=400, num_mc=4, learning_rate=0.02)
    ))(jax.random.split(jax.random.key(3), fits))
    means, sd = np.asarray(res.mean), np.exp(np.asarray(res.log_std)).mean(0)
    return (means.std(0, ddof=1) / sd).tolist()


def main():
    errs = gaussian_errors()
    print(json.dumps({
        "gaussian_max_abs_err_by_key": errs,
        "gaussian_keys_within_0.1": sum(e <= 0.1 for e in errs),
        "gp_mean_spread_over_std": gp_spread(),
    }))


if __name__ == "__main__":
    main()
