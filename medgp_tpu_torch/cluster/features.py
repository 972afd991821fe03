"""Kernel-component feature extraction for population clustering.

Host copy (numpy) of ``medgp_tpu/cluster/features.py``. Maps each trained
(patient, component) pair to the clustering feature vector the reference
uses (medgpc/clustering/feature_extraction.py:18-98):

  * LMC-SM: components with max|B_q| <= 1e-10 are dropped; the feature is the
    SM base response evaluated on a 72-point 1-hour grid plus one flag
    dimension (10.0 if mu > pi*sqrt(v2) else 0.0, where v2 = exp(2*theta_v))
    - 73 dims total.
  * SM: same response per component, weight-gated on exp(theta_w).
  * SE: the scalar lengthscale exp(theta_l), gated on exp(2*theta_s).
"""

from __future__ import annotations

import numpy as np

from medgp_tpu_torch.models.params import LMCSMSpec, SESpec, SMSpec

_SCALE_THR = 1e-10
_GRID_HOURS = 72


def sm_response_curve(mu: np.ndarray, v2: np.ndarray) -> np.ndarray:
    """(..., 72) SM base response on the 1-hour grid.

    Uses the convention of the reference's fastkernel oracle
    (visualization/fastkernel.py:33-47): response(r) =
    exp(-2*pi^2 * v2 * r^2) * cos(2*pi * r * mu), with v2 the *squared*
    bandwidth exp(2*theta_v) and numpy's pi.
    """
    r = np.arange(_GRID_HOURS, dtype=np.float64)
    rsq = r * r
    mu = np.asarray(mu, np.float64)[..., None]
    v2 = np.asarray(v2, np.float64)[..., None]
    return np.exp(-2.0 * np.pi**2 * v2 * rsq) * np.cos(2.0 * np.pi * r * mu)


def periodicity_flag(mu: np.ndarray, v2: np.ndarray) -> np.ndarray:
    return np.where(mu > np.pi * np.sqrt(v2), 10.0, 0.0)


def extract_lmcsm_features(
    spec: LMCSMSpec, pans: np.ndarray, hyps: np.ndarray
):
    """(comp_pan, comp_qidx, comp_feature (m, 73)). `hyps` is (P, H) flat
    theta per trained patient."""
    Q, D, R = spec.Q, spec.D, spec.R
    P = hyps.shape[0]
    assert hyps.shape[1] == spec.n_hyp, (hyps.shape, spec.n_hyp)

    A = hyps[:, D : D + Q * D * R].reshape(P, Q, D, R)
    mu = np.exp(hyps[:, D + Q * D * R : D + Q * D * R + Q])            # (P,Q)
    v2 = np.exp(2.0 * hyps[:, D + Q * (D * R + 1) : D + Q * (D * R + 2)])
    kappa = np.exp(hyps[:, D + Q * (D * R + 2) :]).reshape(P, Q, D)

    B = np.einsum("pqdr,pqer->pqde", A, A)
    B[:, :, np.arange(D), np.arange(D)] += kappa
    keep = np.abs(B).reshape(P, Q, -1).max(-1) > _SCALE_THR          # (P,Q)

    resp = sm_response_curve(mu, v2)                                  # (P,Q,72)
    flag = periodicity_flag(mu, v2)                                   # (P,Q)
    feats = np.concatenate([resp, flag[..., None]], axis=-1)          # (P,Q,73)

    pi, qi = np.nonzero(keep)
    return pans[pi], qi.astype(np.int64), feats[pi, qi]


def extract_sm_features(spec: SMSpec, pans: np.ndarray, hyps: np.ndarray):
    Q = spec.Q
    w = np.exp(hyps[:, 1 : 1 + Q])
    mu = np.exp(hyps[:, 1 + Q : 1 + 2 * Q])
    v2 = np.exp(2.0 * hyps[:, 1 + 2 * Q : 1 + 3 * Q])
    keep = np.abs(w) > _SCALE_THR
    resp = sm_response_curve(mu, v2)
    flag = periodicity_flag(mu, v2)
    feats = np.concatenate([resp, flag[..., None]], axis=-1)
    pi, qi = np.nonzero(keep)
    return pans[pi], qi.astype(np.int64), feats[pi, qi]


def extract_se_features(pans: np.ndarray, hyps: np.ndarray):
    sf2 = np.exp(2.0 * hyps[:, 2])
    keep = np.abs(sf2) > _SCALE_THR
    feats = np.exp(hyps[:, 1])  # lengthscale
    pi = np.nonzero(keep)[0]
    return pans[pi], np.zeros(len(pi), np.int64), feats[pi]


def extract_kernel_features(spec, pans, hyps):
    if isinstance(spec, LMCSMSpec):
        return extract_lmcsm_features(spec, pans, hyps)
    if isinstance(spec, SMSpec):
        return extract_sm_features(spec, pans, hyps)
    if isinstance(spec, SESpec):
        return extract_se_features(pans, hyps)
    raise TypeError(f"unsupported spec {spec!r}")
