"""Online one-step-ahead imputation (the test stage), in both modes.

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

Without updates (`mean_wo_update`), where JAX maps over timestamps per
patient (`lax.map` under `vmap`), the port flattens the valid (patient,
timestamp) pairs of a padded bucket and runs them in chunks: each chunk is
one batch of K3 (`chol_solve`) and K5 (`tri_inv`) systems, after one K1
gram per patient. With updates (`mean_w_update`) the timestamps are a
sequence: each step updates the hypers of the bucket's patients by
momentum SGD on their 72 h window (K1, K3, K4 and K2 per update), then
predicts (K1, K3, K5), as the JAX package's `lax.scan` does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from medgp_tpu_torch.models.gp import (
    PatientData, noise_variance, noiseless_gram, objective_and_grad,
)
from medgp_tpu_torch.models.params import KernelSpec
from medgp_tpu_torch.models.priors import PriorSpec
from medgp_tpu_torch.ops import cuda_chol
from medgp_tpu_torch.ops.nlml import jittered_chol_solve, mask_gram
from medgp_tpu_torch.utils import metrics
from medgp_tpu_torch.utils.hbm import test_chunk_pairs

# mean_w_update (main_one_test.cpp:286-309): the history window of an
# update and of the prediction after it, and the update gate: timestamp
# index > UPDATE_MIN_INDEX and more than UPDATE_MIN_GAP hours since the
# patient's last update.
WINDOW_HOURS = 72.0
UPDATE_MIN_GAP = 5.0 / 60.0
UPDATE_MIN_INDEX = 3


class OnlineResult(NamedTuple):
    """Per-observation results on the padded observation axis, (B, n)."""

    pred: torch.Tensor    # predictive mean (0.0 on fallback)
    error: torch.Tensor   # pred - y
    ci: torch.Tensor      # int32 {0, 1} 95% CI coverage flag
    var: torch.Tensor     # predictive variance (mode noise^2 on fallback)
    valid: torch.Tensor   # bool: this observation produced an output
    theta_final: torch.Tensor  # (B, H) hypers after the last online update


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


def _loo_at_timestamp(K, noise_var, y, m_S, max_retries: int):
    """LOO mean/var of every observation in S for a batch of systems.

    K (P, n, n) noiseless grams, noise_var / y / m_S (P, n)
    -> mean, var (P, n) and ok (P,)."""
    Km = mask_gram(K, m_S)
    y_eff = y * m_S
    noise_eff = noise_var * m_S
    L, alpha, linvd, ok, _mult = jittered_chol_solve(Km, y_eff, noise_eff, max_retries)
    del Km
    Linv = cuda_chol.tri_inv(L, linvd)
    del L
    diag_inv = torch.sum(Linv * Linv, dim=-2)  # diag(K_S^{-1})
    mean = y - alpha / diag_inv
    var = 1.0 / diag_inv
    return mean, var, ok


def _predict_timestamp(
    K, noise_var, t, y, meta, mask, mode_noise_std, u_t,
    max_retries: int,
):
    """Predictions for the observations at u_t (P,) of each system; every
    other argument is per system, (P, n) or (P, n, n).
    Returns (pred, err, ci, var, m_curr), each (P, n)."""
    u = u_t[:, None]
    is_past = mask * (t < u).to(mask.dtype)
    m_curr = mask * (t == u).to(mask.dtype)
    pred, err, ci, var_out = _predict_from_history(
        K, noise_var, y, meta, is_past, m_curr, mode_noise_std, max_retries,
    )
    return pred, err, ci, var_out, m_curr


def _predict_from_history(
    K, noise_var, y, meta, is_past, m_curr, mode_noise_std, max_retries,
):
    """LOO predictions of the observations in m_curr from S = is_past u
    m_curr, with the fallback and CI rules; each result (P, n)."""
    m_S = torch.maximum(is_past, m_curr)
    mean, var, ok = _loo_at_timestamp(K, noise_var, y, m_S, max_retries)

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
    return pred, err, ci, var_out


def online_impute(
    spec: KernelSpec,
    mode_theta: torch.Tensor,
    data: PatientData,
    u_times: torch.Tensor,
    u_valid: torch.Tensor,
    update: bool = False,
    prior: PriorSpec | None = None,
    learn_rate: float = 1e-5,
    momentum: float = 0.9,
    max_retries: int = 10,
) -> OnlineResult:
    """The online-imputation pass for a padded batch of patients.

    data: (B, n) tensors; u_times / u_valid: (B, T) from `unique_times`
    (on data's device). Without updates the (patient, timestamp) systems
    run in kernel batches sized by the memory budget of utils/hbm.py; with
    `update=True` see `_impute_with_updates`."""
    if update:
        return _impute_with_updates(
            spec, mode_theta, data, u_times, u_valid, prior, learn_rate,
            momentum, max_retries,
        )
    n = data.t.shape[1]
    mode_noise_std = spec.unpack(mode_theta)["noise_std"]
    K = noiseless_gram(spec, mode_theta, data)
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
            max_retries,
        )
        # scatter back onto the observation axis: each valid observation
        # belongs to exactly one unique timestamp
        pred.index_add_(0, idx, p_ * w)
        err.index_add_(0, idx, e_ * w)
        var.index_add_(0, idx, v_ * w)
        ci.index_add_(0, idx, c_ * w.to(torch.int32))
        wsum.index_add_(0, idx, w)
    theta_final = mode_theta.expand(data.t.shape[0], -1)
    return OnlineResult(
        pred=pred, error=err, ci=ci, var=var, valid=wsum > 0,
        theta_final=theta_final,
    )


def _impute_with_updates(
    spec, mode_theta, data, u_times, u_valid, prior, learn_rate, momentum,
    max_retries,
) -> OnlineResult:
    """`mean_w_update`: the JAX package's `lax.scan` over timestamps
    (online.py:214-264) as a loop over the timestamp index, batched over the
    bucket's patients, each carrying its own (theta, delta, last_t).

    At step idx every patient with a valid idx-th timestamp u_t may first
    update its hypers by momentum SGD on the MAP objective of its 72 h
    window (the gate: idx > UPDATE_MIN_INDEX and u_t - last_t >
    UPDATE_MIN_GAP; a failed objective resets theta to the mode and the
    momentum to zero), then predicts the observations at u_t from the same
    window under its current theta. Patients whose gate is closed (or whose
    timestamps ran out) are left out of that step's batches, which gives
    the JAX program's selects. Each step's update (its gate included) is
    the span `medgp.online.update`, its prediction `medgp.online.predict`
    (utils/metrics.py)."""
    Bt = u_times.shape[0]
    dtype = mode_theta.dtype
    dev = data.t.device
    mode_noise_std = spec.unpack(mode_theta)["noise_std"]
    theta = mode_theta.expand(Bt, -1).clone()
    delta = torch.zeros_like(theta)
    last_t = u_times[:, 0].clone()  # the last update time starts at the first timestamp

    pred = torch.zeros_like(data.y)
    err = torch.zeros_like(data.y)
    var = torch.zeros_like(data.y)
    ci = torch.zeros(data.y.shape, dtype=torch.int32, device=dev)
    wsum = torch.zeros_like(data.y)
    n_steps = int(u_valid.sum(dim=1).max()) if Bt else 0
    for idx in range(n_steps):
        live = torch.nonzero(u_valid[:, idx]).squeeze(-1)
        if live.numel() == 0:
            continue
        u_t = u_times[live, idx]
        d = data.rows(live)
        in_window = (d.t < u_t[:, None]) & ((u_t[:, None] - d.t) <= WINDOW_HOURS)
        m_past = d.mask * in_window.to(dtype)

        if idx > UPDATE_MIN_INDEX:
            with metrics.span("medgp.online.update"):
                gate = (u_t - last_t[live]) > UPDATE_MIN_GAP
                upd = live[gate]
                if upd.numel():
                    past = PatientData(
                        t=data.t[upd], y=data.y[upd], meta=data.meta[upd],
                        mask=m_past[gate],
                    )
                    f = objective_and_grad(spec, past, prior, max_retries)
                    _value, grad, ok = f(theta[upd])
                    d_new = momentum * delta[upd] + learn_rate * grad
                    th_new = theta[upd] - d_new
                    okc = ok[:, None]
                    theta[upd] = torch.where(okc, th_new, mode_theta.expand_as(th_new))
                    delta[upd] = torch.where(okc, d_new, torch.zeros_like(d_new))
                    last_t[upd] = u_t[gate]

        with metrics.span("medgp.online.predict"):
            th = theta[live]
            K = noiseless_gram(spec, th, d)
            nv = noise_variance(spec, th, d.meta)
            m_curr = d.mask * (d.t == u_t[:, None]).to(dtype)
            p_, e_, c_, v_ = _predict_from_history(
                K, nv, d.y, d.meta, m_past, m_curr, mode_noise_std, max_retries,
            )
            pred.index_add_(0, live, p_ * m_curr)
            err.index_add_(0, live, e_ * m_curr)
            var.index_add_(0, live, v_ * m_curr)
            ci.index_add_(0, live, c_ * m_curr.to(torch.int32))
            wsum.index_add_(0, live, m_curr)
    return OnlineResult(
        pred=pred, error=err, ci=ci, var=var, valid=wsum > 0,
        theta_final=theta,
    )
