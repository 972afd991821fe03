"""Online one-step-ahead imputation (the test stage), without updates.

Counterpart of ``medgp_tpu/infer/online.py``. At every unique timestamp of
a patient, each observation is predicted from all strictly-earlier
observations plus the *other* observations at the same timestamp. One
masked factorization over S = past u current serves all of them through
the exact leave-one-out identities

    mean_j = y_j - [K_S^{-1} y]_j / [K_S^{-1}]_jj,   var_j = 1 / [K_S^{-1}]_jj

with diag(K_S^{-1}) the column sums of squares of L^{-1}.

Semantics kept from the JAX package: the fallback rule (factorization
failed, or S \\ {j} empty: predict 0), the mode-noise CI gate
1.96 * exp(mode_theta[lik]) on fallback, the 95% CI flag
|err| <= 1.96 sqrt(var) otherwise, the `u_valid` masking, and the scatter
back to the observation axis.

Where JAX maps over timestamps per patient (`lax.map` under `vmap`), the
port flattens the valid (patient, timestamp) pairs of a padded bucket and
runs them in chunks: each chunk is one batch of K3 (`chol_solve`) and K5
(`tri_inv`) systems, after one K1 gram per patient.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from medgp_tpu_torch.models.gp import PatientData, noise_variance, noiseless_gram
from medgp_tpu_torch.models.params import KernelSpec
from medgp_tpu_torch.ops import cuda_chol
from medgp_tpu_torch.ops.nlml import jittered_chol_solve, mask_gram
from medgp_tpu_torch.utils.hbm import test_chunk_pairs


class OnlineResult(NamedTuple):
    """Per-observation results on the padded observation axis, (B, n)."""

    pred: torch.Tensor    # predictive mean (0.0 on fallback)
    error: torch.Tensor   # pred - y
    ci: torch.Tensor      # int32 {0, 1} 95% CI coverage flag
    var: torch.Tensor     # predictive variance (mode noise^2 on fallback)
    valid: torch.Tensor   # bool: this observation produced an output


def unique_times(t: np.ndarray, mask: np.ndarray, pad_to: int | None = None):
    """Host-side: sorted unique timestamps of the valid observations, padded.

    Returns (u_times (T_pad,) float32, u_valid (T_pad,) bool), as
    main_one_test.cpp:226-230 sorts and uniques."""
    tv = np.asarray(t)[np.asarray(mask) > 0]
    u = np.unique(tv)
    T = len(u)
    pad_to = pad_to or T
    out = np.zeros(pad_to, np.float32)
    out[:T] = u
    valid = np.zeros(pad_to, bool)
    valid[:T] = True
    return out, valid


def _loo_at_timestamp(K, noise_var, y, m_S, max_retries: int, plain: bool):
    """LOO mean/var of every observation in S for a batch of systems.

    K (P, n, n) noiseless grams, noise_var / y / m_S (P, n)
    -> mean, var (P, n) and ok (P,)."""
    Km = mask_gram(K, m_S)
    y_eff = y * m_S
    noise_eff = noise_var * m_S
    L, alpha, linvd, ok, _mult = jittered_chol_solve(
        Km, y_eff, noise_eff, max_retries, plain=plain
    )
    del Km
    inv = cuda_chol.tri_inv_plain if plain else cuda_chol.tri_inv
    Linv = inv(L, linvd)
    del L
    diag_inv = torch.sum(Linv * Linv, dim=-2)  # diag(K_S^{-1})
    mean = y - alpha / diag_inv
    var = 1.0 / diag_inv
    return mean, var, ok


def _predict_timestamp(
    K, noise_var, t, y, meta, mask, mode_noise_std, u_t,
    max_retries: int, plain: bool,
):
    """Predictions for the observations at u_t (P,) of each system; every
    other argument is per system, (P, n) or (P, n, n).
    Returns (pred, err, ci, var, m_curr), each (P, n)."""
    u = u_t[:, None]
    is_past = mask * (t < u).to(mask.dtype)
    m_curr = mask * (t == u).to(mask.dtype)
    m_S = torch.maximum(is_past, m_curr)

    mean, var, ok = _loo_at_timestamp(K, noise_var, y, m_S, max_retries, plain)

    # fallback: factorization failed, or S \ {j} is empty for this obs
    # (single current obs with no usable history)
    use_fallback = (~ok)[:, None] | (
        (torch.sum(m_S, dim=-1, keepdim=True) <= 1.0) & (m_curr > 0)
    )
    pred = torch.where(use_fallback, torch.zeros_like(mean), mean)
    err = pred - y
    sigma_mode = mode_noise_std[meta.long()]
    var_pos = torch.clamp(var, min=0.0)
    var_out = torch.where(use_fallback, sigma_mode**2, var_pos)
    ci_normal = torch.abs(err) <= 1.96 * torch.sqrt(var_pos)
    ci_fallback = torch.abs(err) <= 1.96 * sigma_mode
    ci = torch.where(use_fallback, ci_fallback, ci_normal).to(torch.int32)
    return pred, err, ci, var_out, m_curr


def online_impute(
    spec: KernelSpec,
    mode_theta: torch.Tensor,
    data: PatientData,
    u_times: torch.Tensor,
    u_valid: torch.Tensor,
    update: bool = False,
    max_retries: int = 10,
    plain: bool = False,
) -> OnlineResult:
    """The online-imputation pass for a padded batch of patients.

    data: (B, n) tensors; u_times / u_valid: (B, T) from `unique_times`
    (on data's device). The (patient, timestamp) systems run in kernel
    batches sized by the memory budget of utils/hbm.py. `plain=True` runs
    the kernels' plain twins on any device."""
    if update:
        raise NotImplementedError(
            "online_impute(update=True) (the mean_w_update test mode) needs "
            "the objective gradient, which is ported with the training slice"
        )
    n = data.t.shape[1]
    mode_noise_std = spec.unpack(mode_theta)["noise_std"]
    K = noiseless_gram(spec, mode_theta, data, plain=plain)
    nv = noise_variance(spec, mode_theta, data.meta)

    pb, pt = torch.nonzero(u_valid, as_tuple=True)  # valid pairs, patient-major
    pu = u_times[pb, pt]
    chunk = test_chunk_pairs(n, data.t.device)

    pred = torch.zeros_like(data.y)
    err = torch.zeros_like(data.y)
    var = torch.zeros_like(data.y)
    ci = torch.zeros(data.y.shape, dtype=torch.int32, device=data.y.device)
    wsum = torch.zeros_like(data.y)
    for s in range(0, pb.numel(), chunk):
        idx = pb[s : s + chunk]
        p_, e_, c_, v_, w = _predict_timestamp(
            K[idx], nv[idx], data.t[idx], data.y[idx], data.meta[idx],
            data.mask[idx], mode_noise_std, pu[s : s + chunk],
            max_retries, plain,
        )
        # scatter back onto the observation axis: each valid observation
        # belongs to exactly one unique timestamp
        pred.index_add_(0, idx, p_ * w)
        err.index_add_(0, idx, e_ * w)
        var.index_add_(0, idx, v_ * w)
        ci.index_add_(0, idx, c_ * w.to(torch.int32))
        wsum.index_add_(0, idx, w)
    return OnlineResult(pred=pred, error=err, ci=ci, var=var, valid=wsum > 0)
