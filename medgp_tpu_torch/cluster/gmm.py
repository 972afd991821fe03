"""Full-covariance Gaussian mixture EM with BIC model selection, in torch.

Counterpart of ``medgp_tpu/cluster/gmm.py``, the replacement for the
reference's sklearn GaussianMixture usage (medgpc/clustering/cluster.py:
23-46 `run_sklearn_gmm`): BIC-scored model selection over
1..max_cluster_num components, full covariances, several random
initializations, max_iter=2000, hard assignment by posterior argmax.

  * Each init is k-means++ seeding plus 10 Lloyd steps, drawn from a
    `torch.Generator` seeded with the caller's seed (the JAX package draws
    from `jax.random`, so the two packages start EM from other centres;
    `fit_em` takes given centres, which is how the two are compared).
  * All inits run EM as one batch of (n_init, k, d, d) covariances in
    float32 on the device. A member stops changing once its own
    |ll - prev_ll| <= tol, while the others go on (the JAX package's
    masked while-loop under vmap); the loop ends when no member runs,
    which the host reads once per EM iteration.
  * EM convergence follows sklearn: the change of the mean log-likelihood
    per sample below tol (1e-3); reg_covar=1e-6 on covariance diagonals.
  * BIC = -2 * total_loglik + n_params * log(n), with
    n_params = k*d + k*d*(d+1)/2 + (k-1)  (sklearn's `_n_parameters`).
  * `algorithm="sklearn"` imports sklearn when called and runs it on the
    host, as the JAX package does; where sklearn is not installed (the
    card's machine has none) it raises ImportError.

The port runs on the true sample count: the JAX package pads it to a power
of two to bound XLA recompiles, which torch has no need of.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class GMMParams(NamedTuple):
    """Leading dims (..., k): one mixture per leading index."""

    weights: torch.Tensor  # (..., k)
    means: torch.Tensor    # (..., k, d)
    covs: torch.Tensor     # (..., k, d, d)


def _log_gaussian(X, means, covs, reg):
    """(I, n, k) log N(x | mu_k, Sigma_k) via Cholesky, for I mixtures. A
    covariance that is not positive definite gives NaN, as XLA's Cholesky
    does (and without a host sync)."""
    d = X.shape[1]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    L, info = torch.linalg.cholesky_ex(covs + reg * eye)  # (I, k, d, d)
    L = torch.where((info == 0)[..., None, None], L, torch.nan)
    diff = X[None, None, :, :] - means[:, :, None, :]  # (I, k, n, d)
    sol = torch.linalg.solve_triangular(L, diff.transpose(-1, -2), upper=False)
    maha = (sol * sol).sum(-2).transpose(1, 2)  # (I, n, k)
    logdet = torch.log(torch.diagonal(L, dim1=-2, dim2=-1)).sum(-1)  # (I, k)
    return -0.5 * (d * math.log(2 * math.pi) + maha) - logdet[:, None, :]


def _e_step(X, p: GMMParams, reg):
    """Responsibilities (I, n, k) and mean log-likelihood (I,)."""
    logp = _log_gaussian(X, p.means, p.covs, reg) + torch.log(p.weights)[:, None, :]
    lognorm = torch.logsumexp(logp, dim=2, keepdim=True)
    return torch.exp(logp - lognorm), lognorm[..., 0].sum(1) / X.shape[0]


def _m_step(X, resp, reg):
    nk = resp.sum(1) + 1e-10  # (I, k)
    weights = nk / X.shape[0]
    means = torch.einsum("ink,nd->ikd", resp, X) / nk[..., None]
    diff = X[None, :, None, :] - means[:, None, :, :]  # (I, n, k, d)
    covs = torch.einsum("inkd,inke->ikde", resp[..., None] * diff, diff)
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    return GMMParams(weights, means, covs / nk[..., None, None] + reg * eye)


def _sq_dist(X, centers):
    """(I, n, k) squared distances of the rows of X to each init's centres."""
    return ((X[None, :, None, :] - centers[:, None, :, :]) ** 2).sum(-1)


def lloyd(X, centers, steps: int = 10):
    """`steps` Lloyd iterations from centres (I, k, d); an empty cluster's
    centre goes to the origin, as in the JAX package."""
    k = centers.shape[1]
    for _ in range(steps):
        onehot = torch.nn.functional.one_hot(
            _sq_dist(X, centers).argmin(2), k
        ).to(X.dtype)
        nk = onehot.sum(1) + 1e-10
        centers = torch.einsum("ink,nd->ikd", onehot, X) / nk[..., None]
    return centers


def kmeans_pp_init(gen: torch.Generator, X, k: int, n_init: int):
    """(n_init, k, d) centres: k-means++ seeding drawn from `gen`, then 10
    Lloyd steps. A draw over all-zero distances (fewer distinct rows than
    centres) is uniform."""
    n = X.shape[0]
    rows = torch.arange(n_init, device=X.device)
    first = torch.multinomial(
        torch.ones(n_init, n, dtype=X.dtype, device=X.device), 1, generator=gen
    )[:, 0]
    centers = X[first][:, None, :].repeat(1, k, 1)
    d2 = torch.full((n_init, n), torch.inf, dtype=X.dtype, device=X.device)
    for i in range(1, k):
        d2 = torch.minimum(d2, ((X[None] - centers[:, i - 1, None, :]) ** 2).sum(-1))
        probs = torch.where(d2.sum(1, keepdim=True) > 0, d2, torch.ones_like(d2))
        idx = torch.multinomial(probs, 1, generator=gen)[:, 0]
        centers[rows, i] = X[idx]
    return lloyd(X, centers)


def fit_em(X, centers, max_iter: int = 2000, tol: float = 1e-3, reg: float = 1e-6):
    """EM for each of I inits from its centres (I, k, d): hard assignment
    to the nearest centre, an M-step, then EM until each member's change
    of mean log-likelihood is at most `tol` or it reached `max_iter`.
    Returns (GMMParams with leading dim I, final mean log-likelihood (I,))."""
    k = centers.shape[1]
    resp0 = torch.nn.functional.one_hot(_sq_dist(X, centers).argmin(2), k).to(X.dtype)
    p = _m_step(X, resp0, reg)
    I = centers.shape[0]
    ll = torch.full((I,), torch.inf, dtype=X.dtype, device=X.device)
    prev_ll = torch.full((I,), -torch.inf, dtype=X.dtype, device=X.device)
    it = torch.zeros(I, dtype=torch.int32, device=X.device)
    while True:
        running = (it < max_iter) & ((ll - prev_ll).abs() > tol)
        if not bool(running.any()):  # one host sync per EM iteration
            break
        resp, new_ll = _e_step(X, p, reg)
        new_p = _m_step(X, resp, reg)
        p = GMMParams(*(
            torch.where(running.view(-1, *[1] * (a.dim() - 1)), b, a)
            for a, b in zip(p, new_p)
        ))
        prev_ll = torch.where(running, ll, prev_ll)
        ll = torch.where(running, new_ll, ll)
        it = it + running.to(it.dtype)
    _, final_ll = _e_step(X, p, reg)
    return p, final_ll


def fit_gmm(gen, X, k: int, n_init: int = 10, max_iter: int = 2000,
            tol: float = 1e-3, reg: float = 1e-6):
    """Best-of-n_init EM fit for a fixed component count k: (GMMParams of
    one mixture, its mean log-likelihood, a 0-dim tensor)."""
    p, lls = fit_em(X, kmeans_pp_init(gen, X, k, n_init), max_iter, tol, reg)
    best = torch.argmax(lls)
    return GMMParams(*(a[best] for a in p)), lls[best]


def bic(n: int, d: int, k: int, mean_ll: float) -> float:
    n_params = k * d + k * d * (d + 1) // 2 + (k - 1)
    return -2.0 * mean_ll * n + n_params * math.log(n)


def predict(X, p: GMMParams, reg: float = 1e-6):
    """Hard assignment (n,) of one mixture's rows."""
    resp, _ = _e_step(X, GMMParams(*(a[None] for a in p)), reg)
    return torch.argmax(resp[0], dim=1)


def run_gmm_bic(
    feature: np.ndarray,
    max_cluster_num: int,
    init_num: int = 10,
    max_iter_num: int = 2000,
    seed: int = 0,
    algorithm: str = "gmm",
    device="cuda",
):
    """BIC model selection over 1..max_cluster_num; returns (best_k,
    assignments (n,) int). `algorithm="gmm"` runs EM in float32 on
    `device`; `algorithm="sklearn"` runs sklearn on the host."""
    X = np.asarray(feature, np.float64)
    if X.ndim == 1:
        X = X[:, None]
    if algorithm == "sklearn":
        from sklearn import mixture

        lowest, best_k, best_assign = np.inf, None, None
        for k in range(1, max_cluster_num + 1):
            g = mixture.GaussianMixture(
                n_components=k, covariance_type="full",
                max_iter=max_iter_num, n_init=init_num,
            )
            g.fit(X)
            b = g.bic(X)
            if b < lowest:
                lowest, best_k, best_assign = b, k, g.predict(X)
        return best_k, np.asarray(best_assign)

    n, d = X.shape
    Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
    gen = torch.Generator(device=Xd.device).manual_seed(seed)
    lowest, best_k, best_assign = np.inf, None, None
    for k in range(1, max_cluster_num + 1):
        p, mean_ll = fit_gmm(gen, Xd, k, n_init=init_num, max_iter=max_iter_num)
        b = bic(n, d, k, float(mean_ll))
        if b < lowest:
            lowest, best_k = b, k
            best_assign = predict(Xd, p).cpu().numpy()
    return best_k, best_assign


def run_clustering_top(algorithm, feature, max_cluster_num, init_num=10,
                       max_iter_num=2000, seed=0, device="cuda"):
    """Dispatch mirroring the reference (cluster.py:5-20): algorithm None
    means a single cluster containing every component."""
    algorithm = str(algorithm)
    feature = np.asarray(feature)
    if algorithm == "None":
        return 1, np.zeros(feature.shape[0], int)
    if algorithm in ("gmm", "sklearn"):
        return run_gmm_bic(
            feature, max_cluster_num, init_num, max_iter_num, seed,
            algorithm=algorithm, device=device,
        )
    raise NotImplementedError(f"unsupported clustering algorithm {algorithm}")
