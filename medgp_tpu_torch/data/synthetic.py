"""Synthetic cohorts for tests, the chip check and benchmarks.

Counterpart of ``medgp_tpu/data/synthetic.py``, in numpy, drawing the same
numbers from the same seed: ground-truth LMC-SM kernels per latent cluster,
then each patient's irregular observation grid and GP sample. Also writes
the cohort in the reference's on-disk layout.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import PatientRecord
from medgp_tpu_torch.models.params import REF_PI, LMCSMSpec


def sample_cluster_params(rng, spec: LMCSMSpec, sparsity: float = 0.5):
    """One population cluster's ground-truth kernel (natural params)."""
    Q, D, R = spec.Q, spec.D, spec.R
    A = rng.normal(size=(Q, D, R)) * 0.4
    A *= rng.random(size=(Q, D, R)) > sparsity  # sparse factors
    period = rng.uniform(12, 72, size=Q)
    lscale = rng.uniform(6, 72, size=Q)
    mu = 1.0 / period
    v = 1.0 / (2 * REF_PI * lscale)
    kappa = rng.uniform(0.01, 0.05, size=(Q, D))
    noise_std = rng.uniform(0.15, 0.4, size=D)
    return dict(A=A, mu=mu, v=v, kappa=kappa, noise_std=noise_std)


def params_to_theta(spec: LMCSMSpec, p: dict) -> np.ndarray:
    """Natural params -> flat theta (inverse of spec.unpack)."""
    return np.concatenate(
        [
            np.log(p["noise_std"]).ravel(),
            p["A"].ravel(),
            np.log(p["mu"]).ravel(),
            np.log(p["v"]).ravel(),
            np.log(p["kappa"]).ravel(),
        ]
    )


def sample_patient(
    rng,
    spec: LMCSMSpec,
    params: dict,
    n_obs: int,
    t_max: float = 7 * 24.0,
    pan: str = "synthetic",
) -> PatientRecord:
    Q, D = spec.Q, spec.D
    t = np.sort(rng.uniform(0, t_max, size=n_obs)).astype(np.float32)
    meta = rng.integers(0, D, size=n_obs).astype(np.int32)
    # guarantee the data-quality gate (>=2 obs per output)
    meta[: 2 * D] = np.tile(np.arange(D), 2)
    B = np.stack(
        [params["A"][q] @ params["A"][q].T + np.diag(params["kappa"][q])
         for q in range(Q)]
    )
    rsq = (t[:, None] - t[None, :]).astype(np.float64) ** 2
    K = np.zeros((n_obs, n_obs))
    for q in range(Q):
        r = np.sqrt(rsq)
        kq = np.cos(2 * REF_PI * r * params["mu"][q]) * np.exp(
            -2 * (REF_PI * params["v"][q]) ** 2 * rsq
        )
        K += B[q][np.ix_(meta, meta)] * kq
    # jitter escalation: a draw with near-duplicate timestamps can be
    # numerically indefinite at fp64 (c_inference_exact.cpp:99-111)
    jitter = 1e-6 * max(1.0, float(np.trace(K)) / n_obs)
    for _ in range(12):
        try:
            L = np.linalg.cholesky(K + jitter * np.eye(n_obs))
            break
        except np.linalg.LinAlgError:
            jitter *= 10.0
    else:
        raise np.linalg.LinAlgError(
            f"synthetic gram for {pan} not PSD even with jitter {jitter:.1e}"
        )
    f = L @ rng.normal(size=n_obs)
    y = f + params["noise_std"][meta] * rng.normal(size=n_obs)
    return PatientRecord(pan=pan, t=t, y=y.astype(np.float32), meta=meta)


def sample_cohort(
    seed: int,
    spec: LMCSMSpec,
    n_patients: int,
    n_clusters: int = 2,
    n_obs_range=(40, 200),
    t_max: float = 7 * 24.0,
) -> List[PatientRecord]:
    rng = np.random.default_rng(seed)
    clusters = [sample_cluster_params(rng, spec) for _ in range(n_clusters)]
    recs = []
    for i in range(n_patients):
        c = clusters[int(rng.integers(0, n_clusters))]
        n = int(rng.integers(*n_obs_range))
        recs.append(
            sample_patient(rng, spec, c, n, t_max, pan=f"syn{i:05d}")
        )
    return recs


def cluster_thetas(seed: int, spec: LMCSMSpec, n_clusters: int = 2):
    """Flat theta of each ground-truth cluster that `sample_cohort(seed,
    spec, ..., n_clusters)` draws first from its generator."""
    rng = np.random.default_rng(seed)
    return [
        params_to_theta(spec, sample_cluster_params(rng, spec))
        for _ in range(n_clusters)
    ]


def write_reference_format_cohort(
    out_dir: str,
    records: List[PatientRecord],
    feature_index: List[int],
    id_list_name: str = "cohort_hadm_match.txt",
) -> None:
    """Per-patient feature{idx}.txt, cohort feature{idx}_stat.bin (mean 0,
    std 1, so round trips are exact) and the cohort id list
    (scripts/jmlr_mimic_heart_failure.py:199-339)."""
    os.makedirs(out_dir, exist_ok=True)
    for fidx in feature_index:
        formats.write_feature_stat(
            os.path.join(out_dir, f"feature{fidx}_stat.bin"), 0.0, 1.0
        )
    with open(os.path.join(out_dir, id_list_name), "w") as f:
        for r in records:
            f.write(r.pan + "\n")
    for r in records:
        pdir = os.path.join(out_dir, r.pan)
        os.makedirs(pdir, exist_ok=True)
        for j, fidx in enumerate(feature_index):
            sel = r.meta == j
            formats.write_feature_txt(
                os.path.join(pdir, f"feature{fidx}.txt"), r.t[sel], r.y[sel]
            )
