"""Checkpoint / resume of the train stage at bucket granularity.

Counterpart of ``medgp_tpu/utils/checkpoints.py:CohortCheckpointer``, its
plain-npz path only: each completed bucket is one `bucket_{i}.npz` in the
checkpoint directory. The JAX package writes orbax checkpoints whenever
orbax is installed (an orbax directory per bucket, not these files), so a
checkpoint directory written by one package is not read by the other.

The reference's checkpoints are its stage artifacts; a re-run overwrites
per-patient files and nothing resumes. Here `train_cohort` saves each
bucket's results keyed by its patients, so a re-run restores the buckets
that finished and trains the rest.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


class CohortCheckpointer:
    """One npz file per bucket index."""

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = os.path.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, bucket_idx: int) -> str:
        return os.path.join(self.ckpt_dir, f"bucket_{bucket_idx}.npz")

    def save_bucket(self, bucket_idx: int, state: dict) -> None:
        state = {k: np.asarray(v) for k, v in state.items() if v is not None}
        np.savez(self._path(bucket_idx), **state)

    def load_bucket(self, bucket_idx: int) -> Optional[dict]:
        path = self._path(bucket_idx)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
