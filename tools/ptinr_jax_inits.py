#!/usr/bin/env python3
"""Write the JAX package's restart draws for the PT/INR accuracy arm.

    JAX_PLATFORMS=cpu python3 tools/ptinr_jax_inits.py

tools/refbudget_run.sh's reduced arm trains LMC-SM(Q=5, D=2, R=2) from
16 restarts drawn by `medgp_tpu.data.inits.random_inits` from
jax.random.key(718) within the default bounds (the arm's opt config sets
none). This writes those 16 float32 thetas to tools/ptinr_jax_inits.json,
which chip_smoke.py's accuracy phase trains from, so that the port and
the JAX package's arms share their initialisation. JAX's PRNG gives the
same draws on every backend, so the file holds the draws of the TPU and
the CPU arms alike.
"""

from __future__ import annotations

import json
import os
import sys

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from medgp_tpu.data.inits import default_bounds, random_inits  # noqa: E402
from medgp_tpu.models.params import LMCSMSpec  # noqa: E402

SEED, Q, D, R, N_INITS = 718, 5, 2, 2, 16
OUT = os.path.join(ROOT, "tools", "ptinr_jax_inits.json")


def main() -> int:
    spec = LMCSMSpec(Q, D, R)
    inits = np.asarray(random_inits(
        jax.random.key(SEED), spec, default_bounds(spec), N_INITS), np.float32)
    with open(OUT, "w") as f:
        json.dump(dict(
            source=f"medgp_tpu.data.inits.random_inits(jax.random.key({SEED}), "
                   f"LMCSMSpec({Q}, {D}, {R}), default_bounds(spec), {N_INITS})",
            seed=SEED, spec=[Q, D, R], inits=inits.tolist(),
        ), f, indent=1)
        f.write("\n")
    print(f"wrote {inits.shape} draws to {os.path.relpath(OUT, ROOT)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
