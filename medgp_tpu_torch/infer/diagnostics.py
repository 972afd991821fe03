"""Sampler convergence diagnostics: split-R-hat and bulk ESS.

Host copy (numpy and scipy) of ``medgp_tpu/infer/diagnostics.py``: the
rank-normalized split-R-hat and bulk effective sample size of Vehtari,
Gelman, Simpson, Carpenter & Buerkner (2021), "Rank-normalization,
folding, and localization: An improved R-hat for assessing convergence of
MCMC", and the posterior mean in the LMC-SM kernel's identified
parametrization. Diagnostics run once per patient per run on the host,
off the device's path.

Conventions: `chains` has shape (C, S, H) (chains x draws x params).
Clamped/masked hypers (zero variance) report R-hat = 1 and ESS = C*S —
they carry no Monte-Carlo error by construction.
"""

from __future__ import annotations

import numpy as np


def _split(chains: np.ndarray) -> np.ndarray:
    """(C, S, H) -> (2C, S//2, H): split each chain in half."""
    C, S, H = chains.shape
    half = S // 2
    a = chains[:, :half]
    b = chains[:, half:2 * half]
    return np.concatenate([a, b], axis=0)


def _rank_normalize(chains: np.ndarray) -> np.ndarray:
    """Pooled fractional ranks -> standard-normal scores (per parameter)."""
    from scipy.special import ndtri

    C, S, H = chains.shape
    flat = chains.reshape(C * S, H)
    order = np.argsort(flat, axis=0)
    ranks = np.empty_like(order)
    np.put_along_axis(
        ranks, order,
        np.broadcast_to(np.arange(C * S)[:, None], (C * S, H)), axis=0,
    )
    z = ndtri((ranks + 0.5 + 0.375) / (C * S + 0.25))
    return z.reshape(C, S, H)


def _rhat_of(chains: np.ndarray) -> np.ndarray:
    C, S, H = chains.shape
    mean_c = chains.mean(axis=1)                       # (C, H)
    var_c = chains.var(axis=1, ddof=1)                 # (C, H)
    W = var_c.mean(axis=0)
    B = S * mean_c.var(axis=0, ddof=1)
    var_plus = (S - 1) / S * W + B / S
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / W)
    return np.where(W <= 1e-30, 1.0, rhat)


def split_rhat(chains: np.ndarray) -> np.ndarray:
    """Rank-normalized split-R-hat per parameter: (C, S, H) -> (H,).

    Values near 1.0 indicate between-chain agreement; > 1.01 is the usual
    convergence warning threshold.
    """
    chains = np.asarray(chains, np.float64)
    if chains.ndim == 2:
        chains = chains[None]
    C, S, H = chains.shape
    if S < 4 or C * 2 < 2:
        return np.ones(chains.shape[-1])
    sp = _split(chains)
    # constant parameters (clamped hypers) are exactly converged
    const = sp.std(axis=(0, 1)) <= 1e-30
    z = _rank_normalize(np.where(const[None, None, :], 0.0, sp))
    r = _rhat_of(z)
    return np.where(const, 1.0, r)


def _autocov_fft(x: np.ndarray) -> np.ndarray:
    """Biased autocovariance per chain/param via FFT: (C, S, H)->(C, S, H)."""
    C, S, H = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    nfft = int(2 ** np.ceil(np.log2(2 * S)))
    f = np.fft.rfft(xc, n=nfft, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=nfft, axis=1)[:, :S]
    return acov / S


def ess_bulk(chains: np.ndarray) -> np.ndarray:
    """Rank-normalized bulk effective sample size per parameter:
    (C, S, H) -> (H,). Uses Geyer's initial monotone positive sequence on
    the combined autocorrelation."""
    chains = np.asarray(chains, np.float64)
    if chains.ndim == 2:
        chains = chains[None]
    sp = _split(chains)
    C, S, H = sp.shape
    total = chains.shape[0] * chains.shape[1]
    if S < 4:
        return np.full(H, float(total))
    const = sp.std(axis=(0, 1)) <= 1e-30
    z = _rank_normalize(np.where(const[None, None, :], 0.0, sp))

    acov = _autocov_fft(z)                              # (C, S, H)
    mean_acov0 = acov[:, 0].mean(axis=0)                # W per param
    mean_c = z.mean(axis=1)
    var_plus = mean_acov0 * S / (S - 1.0)
    if C > 1:
        var_plus = var_plus + mean_c.var(axis=0, ddof=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        rho = 1.0 - (mean_acov0[None] - acov.mean(axis=0)) / var_plus[None]
    rho = np.nan_to_num(rho, nan=0.0)                   # (S, H)

    # Geyer: pair sums P_k = rho_{2k} + rho_{2k+1} (P_0 includes rho_0 = 1);
    # truncate at the first nonpositive pair, enforce monotone decrease;
    # tau = -1 + 2 sum P_k  (= 1 + 2 sum_{t>=1} rho_t)
    T = S // 2
    p = rho[: 2 * T].reshape(T, 2, H).sum(axis=1)       # (T, H)
    p = np.minimum.accumulate(p, axis=0)
    first_bad = np.argmax(p <= 0, axis=0)
    has_bad = (p <= 0).any(axis=0)
    idx = np.arange(T)[:, None]
    keep = np.where(has_bad[None], idx < first_bad[None], True)
    p = np.where(p > 0, p, 0.0)
    tau = -1.0 + 2.0 * (p * keep).sum(axis=0)
    tau = np.maximum(tau, 1.0 / np.log10(max(total, 10)))
    ess = total / tau
    ess = np.clip(ess, 1.0, float(total) * np.log10(max(total, 10)))
    return np.where(const, float(total), ess)


def block_slices(spec) -> dict:
    """Hyper-vector blocks for per-block diagnostics reporting (layout:
    lik | A | mu | v | kappa — models/params.py KernelSpec.split)."""
    from medgp_tpu_torch.models.params import LMCSMSpec

    if not isinstance(spec, LMCSMSpec):
        return {"all": slice(0, spec.n_hyp)}
    nl = spec.n_lik
    nA = spec.Q * spec.D * spec.R
    Q = spec.Q
    return {
        "lik": slice(0, nl),
        "A": slice(nl, nl + nA),
        "mu": slice(nl + nA, nl + nA + Q),
        "v": slice(nl + nA + Q, nl + nA + 2 * Q),
        "kappa": slice(nl + nA + 2 * Q, spec.n_hyp),
    }


def summarize_diagnostics(chains: np.ndarray, spec=None) -> dict:
    """Per-hyper-block min-ESS and max-split-R-hat for one patient's
    (C, S, H) sample stack. Returns a flat dict of scalars suitable for
    metrics.jsonl."""
    chains = np.asarray(chains)
    ess = ess_bulk(chains)
    rhat = split_rhat(chains)
    out = {
        "ess_bulk_min": float(np.min(ess)),
        "ess_bulk_median": float(np.median(ess)),
        "rhat_max": float(np.max(rhat)),
    }
    if spec is not None:
        for name, sl in block_slices(spec).items():
            if sl.stop > sl.start:
                out[f"ess_min_{name}"] = float(np.min(ess[sl]))
                out[f"rhat_max_{name}"] = float(np.max(rhat[sl]))
    return out


def invariant_posterior_mean(spec, chains: np.ndarray) -> np.ndarray:
    """Posterior-mean hypers computed in the LMC-SM kernel's IDENTIFIED
    parametrization; (C, S, H) draws -> (H,).

    The naive coordinate-wise mean of theta draws is degenerate for this
    model: B_q = A_q A_q^T + diag(kappa_q) is invariant to per-column
    sign flips / rotations of A_q, and the Q components are exchangeable
    across chains — two well-mixed chains sitting in symmetric modes
    average A toward ZERO (observed round 5: min-bulk-ESS pinned at ~2.3
    for the symmetric coordinates at every budget, and the MAP-vs-
    posterior-mean MAE gate failing by 27 SE). This computes the mean of
    the INVARIANTS instead:

      1. per chain, align the Q components to chain 0 by greedy nearest
         (log mu, log v) centroid matching (label switching across
         chains);
      2. per draw, form B_q (sign/rotation invariant) and average B, log
         mu, log v, log noise (and any trailing mean-function params);
      3. re-factor mean-B per component: A = U sqrt(S)[:, :R] from its
         eigendecomposition, kappa = clamp(diag(B - A A^T), 1e-15) — the
         same split the reference's mode pipeline uses
         (mode_estimate.py:411-420).

    Non-LMC-SM specs fall back to the plain mean (their hypers are
    identified)."""
    from medgp_tpu_torch.models.params import LMCSMSpec

    chains = np.asarray(chains, np.float64)
    if chains.ndim == 2:
        chains = chains[None]
    C, S, H = chains.shape
    if not isinstance(spec, LMCSMSpec) or C * S < 2:
        return chains.reshape(-1, H).mean(0)

    Q, D, R = spec.Q, spec.D, spec.R
    nl = spec.n_lik
    nA = Q * D * R
    sl_A = slice(nl, nl + nA)
    sl_mu = slice(nl + nA, nl + nA + Q)
    sl_v = slice(nl + nA + Q, nl + nA + 2 * Q)
    sl_k = slice(nl + nA + 2 * Q, nl + nA + 2 * Q + Q * D)
    tail = slice(nl + nA + 2 * Q + Q * D, H)

    # 1. component alignment across chains on (log mu, log v) centroids
    cent = np.stack(
        [chains[:, :, sl_mu].mean(1), chains[:, :, sl_v].mean(1)], -1
    )  # (C, Q, 2)
    aligned = chains.copy()
    for c in range(1, C):
        cost = np.linalg.norm(
            cent[0][:, None, :] - cent[c][None, :, :], axis=-1
        )  # (Q_ref, Q_c)
        perm = np.full(Q, -1)
        used = np.zeros(Q, bool)
        for qr in np.argsort(cost.min(axis=1)):
            qc = np.argmin(np.where(used, np.inf, cost[qr]))
            perm[qr] = qc
            used[qc] = True
        A = chains[c, :, sl_A.start:sl_A.stop].reshape(S, Q, D, R)
        K = chains[c, :, sl_k.start:sl_k.stop].reshape(S, Q, D)
        aligned[c, :, sl_A.start:sl_A.stop] = A[:, perm].reshape(S, -1)
        aligned[c, :, sl_mu.start:sl_mu.stop] = chains[c][:, sl_mu][:, perm]
        aligned[c, :, sl_v.start:sl_v.stop] = chains[c][:, sl_v][:, perm]
        aligned[c, :, sl_k.start:sl_k.stop] = K[:, perm].reshape(S, -1)

    draws = aligned.reshape(C * S, H)
    # 2. invariant means
    A_d = draws[:, sl_A].reshape(-1, Q, D, R)
    kap_d = np.exp(draws[:, sl_k]).reshape(-1, Q, D)
    B_d = np.einsum("nqdr,nqer->nqde", A_d, A_d)
    B_d[:, :, np.arange(D), np.arange(D)] += kap_d
    B_bar = B_d.mean(0)  # (Q, D, D)

    out = np.empty(H)
    out[:nl] = draws[:, :nl].mean(0)
    out[sl_mu] = draws[:, sl_mu].mean(0)
    out[sl_v] = draws[:, sl_v].mean(0)
    if tail.start < H:
        out[tail] = draws[:, tail].mean(0)

    # 3. refactor mean-B per component into A A^T + diag(kappa) by
    # alternating projections (a one-line factor-analysis loop: the plain
    # rank-R eigen split drops the off-diagonal remainder when R < D;
    # alternation is exact at any fixed point where B IS rank-R + diag)
    klog_mean = draws[:, sl_k].mean(0).reshape(Q, D)
    for q in range(Q):
        Bq = B_bar[q]
        # kappa is itself invariant (positive diagonal): its log-space
        # posterior mean is the natural seed; the loop then only has to
        # absorb the rank-R truncation remainder
        lam = np.maximum(
            np.minimum(np.exp(klog_mean[q]), np.diag(Bq)), 1e-15
        )
        A_q = np.zeros((D, min(R, D)))
        for _ in range(200):
            w, U = np.linalg.eigh(Bq - np.diag(lam))
            order = np.argsort(w)[::-1][: min(R, D)]
            w_r = np.maximum(w[order], 0.0)
            A_new = U[:, order] * np.sqrt(w_r)
            lam_new = np.maximum(np.diag(Bq - A_new @ A_new.T), 1e-15)
            shift = np.abs(lam_new - lam).max()
            A_q, lam = A_new, lam_new
            if shift < 1e-12:
                break
        if A_q.shape[1] < R:
            A_q = np.concatenate(
                [A_q, np.zeros((D, R - A_q.shape[1]))], axis=1
            )
        # deterministic column signs (largest-magnitude entry positive)
        s = np.sign(A_q[np.argmax(np.abs(A_q), axis=0), np.arange(R)])
        A_q = A_q * np.where(s == 0, 1.0, s)
        out[nl + q * D * R : nl + (q + 1) * D * R] = A_q.reshape(-1)
        out[sl_k.start + q * D : sl_k.start + (q + 1) * D] = np.log(lam)
    return out
