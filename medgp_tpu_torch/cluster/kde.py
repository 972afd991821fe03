"""Gaussian kernel density estimation with Silverman bandwidth + mode rules.

Counterpart of ``medgp_tpu/cluster/kde.py``, replacing the reference's
statsmodels KDEUnivariate usage (medgpc/clustering/mode_estimate.py:438-450):

    kde.fit(kernel="gau", bw="silverman"); dens = kde.evaluate(x)

Silverman bandwidth (statsmodels `bw_silverman`):
    sigma = min(std(x, ddof=1), IQR/1.349) with the IQR term dropped when 0
    bw    = 0.9 * sigma * n^(-1/5)

Two mode definitions, used per kernel family (mode_estimate.py:446-450):
    weighted   : density-weighted mean  sum(x * d) / sum(d)   (LMC-SM)
    unweighted : argmax of the density on the evaluation grid (SE / SM)

Bandwidths and percentiles are computed on the host in numpy, as in the
JAX package; the pairwise Gaussian sums and the modes run in torch float64
on the given device, on the true sample counts (the JAX package pads them
to powers of two to bound XLA recompiles, which torch has no need of).
"""

from __future__ import annotations

import numpy as np
import torch

# bound of each pairwise buffer: ~160 MB of float64 (the JAX package's bound)
_PAIR_ENTRIES = int(2e7)
_NORM = np.sqrt(2.0 * np.pi)


def silverman_bandwidth(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64).ravel()
    n = len(x)
    if n < 2:
        return 1.0
    std = np.std(x, ddof=1)
    q75, q25 = np.percentile(x, [75, 25])
    iqr = (q75 - q25) / 1.349
    sigma = min(std, iqr) if iqr > 0 else std
    if sigma <= 0:
        sigma = max(abs(x[0]), 1.0) * 1e-6  # degenerate sample guard
    return 0.9 * sigma * n ** (-0.2)


def _density(x: np.ndarray, pts: np.ndarray, device) -> torch.Tensor:
    """Silverman-bandwidth Gaussian KDE of the sample `x` at `pts`, a
    float64 tensor on `device`; the (points, samples) buffer is chunked
    over the points."""
    bw = silverman_bandwidth(x)
    xs = torch.as_tensor(x, dtype=torch.float64, device=device)
    ps = torch.as_tensor(pts, dtype=torch.float64, device=device)
    chunk = max(1, _PAIR_ENTRIES // max(len(x), 1))
    ksum = torch.cat([
        torch.exp(-0.5 * torch.square((p[:, None] - xs[None, :]) / bw)).sum(1)
        for p in ps.split(chunk)
    ])
    return ksum / (len(x) * bw * _NORM)


def gaussian_kde(x: np.ndarray, eval_points: np.ndarray, device="cuda") -> np.ndarray:
    """Density of the Silverman-bandwidth Gaussian KDE at `eval_points`."""
    x = np.asarray(x, np.float64).ravel()
    pts = np.asarray(eval_points, np.float64).ravel()
    return _density(x, pts, device).cpu().numpy()


def kde_mode(x: np.ndarray, weighted: bool, eval_points=None, device="cuda") -> float:
    """Mode of the KDE fitted to x, evaluated at `eval_points` (defaults to
    the sample itself, like the reference's `compute_kde(data, data)`)."""
    x = np.asarray(x, np.float64).ravel()
    if len(x) == 1:
        return float(x[0])
    pts = x if eval_points is None else np.asarray(eval_points, np.float64).ravel()
    dens = _density(x, pts, device)
    ps = torch.as_tensor(pts, dtype=torch.float64, device=device)
    if weighted:
        s = torch.nansum(dens)
        mode = torch.where(s <= 0, ps.mean(), torch.nansum(ps * dens) / s)
        return float(mode)
    return float(ps[torch.argmax(dens)])


def kde_mode_batch(X: np.ndarray, weighted: bool = True, device="cuda") -> np.ndarray:
    """Row-wise :func:`kde_mode` over a (M, P) sample matrix, each row
    evaluated at its own samples with its own Silverman bandwidth. The
    (m, P, P) pairwise buffer is chunked over rows."""
    X = np.asarray(X, np.float64)
    M, P = X.shape
    if M == 0:
        return np.zeros(0)
    if P == 1:
        return X[:, 0].copy()
    std = np.std(X, axis=1, ddof=1)
    q75, q25 = np.percentile(X, [75, 25], axis=1)
    iqr = (q75 - q25) / 1.349
    sigma = np.where(iqr > 0, np.minimum(std, iqr), std)
    sigma = np.where(sigma <= 0, np.maximum(np.abs(X[:, 0]), 1.0) * 1e-6, sigma)
    bw = 0.9 * sigma * P ** (-0.2)

    Xd = torch.as_tensor(X, device=device)
    bwd = torch.as_tensor(bw, device=device)
    chunk = max(1, _PAIR_ENTRIES // (P * P))
    out = []
    for Xb, bwb in zip(Xd.split(chunk), bwd.split(chunk)):
        z = (Xb[:, :, None] - Xb[:, None, :]) / bwb[:, None, None]
        dens = torch.exp(-0.5 * torch.square(z)).sum(2) / (P * bwb[:, None] * _NORM)
        if weighted:
            ssum = torch.nansum(dens, 1)
            mode = torch.where(
                ssum <= 0, Xb.mean(1), torch.nansum(Xb * dens, 1) / ssum
            )
        else:
            mode = Xb.gather(1, torch.argmax(dens, 1, keepdim=True))[:, 0]
        out.append(mode)
    return torch.cat(out).cpu().numpy()


def kde_log_density_and_grad(x: float, bw: float, samples: np.ndarray):
    """log p(x) and d log p / dx of a Gaussian KDE - the reference's type-3
    prior density (c_prior.cpp:165-194 `prior_lik_kde`). Host numpy."""
    samples = np.asarray(samples, np.float64).ravel()
    n = len(samples)
    z = (x - samples) / bw
    ds = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
    lp = ds.sum() / (n * bw)
    dlp = -((x - samples) * ds).sum() / (n * bw**3) / lp
    return float(np.log(lp)), float(dlp)
