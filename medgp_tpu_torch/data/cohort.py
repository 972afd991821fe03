"""Cohort assembly: ragged patients -> fixed-shape padded batches.

Counterpart of ``medgp_tpu/data/cohort.py``: patients are grouped by padded
length (buckets of 128 * 2^k) so each bucket runs as one dense (B, n_max)
batch. The per-bucket batch cap comes from the card's free memory
(:mod:`medgp_tpu_torch.utils.hbm`).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

from medgp_tpu_torch.data import formats
from medgp_tpu_torch.utils.hbm import bucket_cap


@dataclasses.dataclass
class PatientRecord:
    """Host-side (numpy, ragged) observations of one patient."""

    pan: str
    t: np.ndarray     # (n,) float32
    y: np.ndarray     # (n,) float32 (normalized)
    meta: np.ndarray  # (n,) int32

    @property
    def n_obs(self) -> int:
        return len(self.t)


@dataclasses.dataclass
class PaddedBatch:
    """A dense bucket of patients (numpy), ready to move to the device."""

    pans: List[str]
    t: np.ndarray     # (B, n_max) float32
    y: np.ndarray     # (B, n_max) float32
    meta: np.ndarray  # (B, n_max) int32
    mask: np.ndarray  # (B, n_max) float32
    n_max: int

    def __len__(self) -> int:
        return len(self.pans)


def load_cohort(
    data_dir: str,
    pans: Sequence[str],
    feature_index: Sequence[int],
) -> List[PatientRecord]:
    recs = []
    for pan in pans:
        t, y, meta = formats.load_patient(data_dir, str(pan), feature_index)
        recs.append(PatientRecord(pan=str(pan), t=t, y=y, meta=meta))
    return recs


BUCKET_MULTIPLE = 128  # padded lengths are multiples of this ...
BUCKET_GROWTH = 2      # ... growing geometrically up to the longest patient


def bucket_edges(ns: Sequence[int]):
    """Padded-length buckets 128, 256, 512, ... below max(ns), then max(ns)
    rounded up to a multiple of 128."""
    top = max(max(ns), 1)
    edges = []
    e = BUCKET_MULTIPLE
    while e < top:
        edges.append(e)
        e *= BUCKET_GROWTH
    edges.append(-(-top // BUCKET_MULTIPLE) * BUCKET_MULTIPLE)
    return edges


def pack_patients(
    records: Sequence[PatientRecord],
    max_batch: int | None = None,
    device: torch.device | str = "cpu",
    footprint_mult: int = 1,
    batch_multiple: int = 1,
    free_bytes: int | None = None,
) -> List[PaddedBatch]:
    """Group patients into padded batches by bucketed length.

    Patients keep their identity (pans list); padding entries have mask 0,
    meta 0, t 0, y 0. Each bucket's batch is capped by `max_batch` and by
    the memory share its grams may take on `device`, divided by
    `footprint_mult`, the number of (n, n) grams a patient holds at once
    (the samplers: two per chain; medgp_tpu/data/cohort.py:127-142).

    `batch_multiple` (the world, when sharding over ranks) promotes each
    length bucket's remainder, its longest patients, into the next-longer
    bucket, so that every bucket but the longest holds a multiple of it
    and all-masked dummies pad at most that one (medgp_tpu/data/cohort.py:
    84-125); the memory cap is then rounded down to a multiple of it.
    `free_bytes` replaces the device's free memory in the cap (over
    several ranks, the least of theirs, so that all pack alike).
    """
    if not records:
        return []
    edges = bucket_edges([r.n_obs for r in records])
    buckets: dict[int, list[PatientRecord]] = {}
    for r in records:
        for e in edges:
            if r.n_obs <= e:
                buckets.setdefault(e, []).append(r)
                break

    if batch_multiple > 1:
        order = sorted(buckets)
        for i, e in enumerate(order[:-1]):
            group = buckets[e]
            rem = len(group) % batch_multiple
            if rem:
                group.sort(key=lambda r: r.n_obs)
                buckets[order[i + 1]] = group[len(group) - rem:] + buckets[order[i + 1]]
                del group[len(group) - rem:]
                if not group:
                    del buckets[e]

    batches = []
    for n_max in sorted(buckets):
        group = buckets[n_max]
        cap = max(1, bucket_cap(n_max, device, free_bytes) // max(footprint_mult, 1))
        if batch_multiple > 1:
            cap = max(batch_multiple, cap - cap % batch_multiple)
        eff = cap if max_batch is None else min(max_batch, cap)
        for s in range(0, len(group), eff):
            chunk = group[s : s + eff]
            B = len(chunk)
            t = np.zeros((B, n_max), np.float32)
            y = np.zeros((B, n_max), np.float32)
            meta = np.zeros((B, n_max), np.int32)
            mask = np.zeros((B, n_max), np.float32)
            for i, r in enumerate(chunk):
                n = r.n_obs
                t[i, :n] = r.t
                y[i, :n] = r.y
                meta[i, :n] = r.meta
                mask[i, :n] = 1.0
            batches.append(
                PaddedBatch(
                    pans=[r.pan for r in chunk],
                    t=t, y=y, meta=meta, mask=mask, n_max=n_max,
                )
            )
    return batches
