"""Cost-balanced shard assignment for heterogeneous patients.

Host copy of ``medgp_tpu/parallel/bucketing.py`` (the port imports nothing
of the JAX package); tests/test_torch_mesh.py holds it to the original.

The reference balances cost with 5 Slurm resource tiers keyed by observation
count (scripts/slurm_della.json; run_exp_generator.py:213-263). On a device
mesh the analog is bin packing: assign patients to shards so per-shard total
cost is even. Cost model: the NLML objective is O(n^3) (Cholesky) + O(Q n^2)
(gram), dominated by n^3 for large n — the same quantity the reference's
tier table keys on.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def patient_cost(n_obs: int, q: int = 5) -> float:
    """Relative cost of one patient's objective evaluation."""
    n = float(max(n_obs, 1))
    return n**3 + q * n * n


def balance_shards(
    costs: Sequence[float], n_shards: int
) -> List[np.ndarray]:
    """Longest-processing-time greedy bin packing.

    Returns per-shard index arrays; LPT is a 4/3-approximation of optimal
    makespan, ample for the ~n^3 cost spread the Slurm tiers handled.
    """
    costs = np.asarray(costs, np.float64)
    order = np.argsort(-costs)
    loads = np.zeros(n_shards)
    shards: List[list] = [[] for _ in range(n_shards)]
    for i in order:
        s = int(np.argmin(loads))
        shards[s].append(int(i))
        loads[s] += costs[i]
    return [np.asarray(sorted(s), int) for s in shards]


def shard_imbalance(costs: Sequence[float], shards: List[np.ndarray]) -> float:
    """max-load / mean-load; 1.0 is perfect."""
    costs = np.asarray(costs, np.float64)
    loads = np.asarray([costs[s].sum() for s in shards])
    return float(loads.max() / max(loads.mean(), 1e-30))
