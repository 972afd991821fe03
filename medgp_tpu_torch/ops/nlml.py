"""Masked negative log marginal likelihood, its gradient, and prediction.

Counterpart of ``medgp_tpu/ops/nlml.py``. Padded rows/columns of a gram
are replaced by identity so one batched factorization serves every padded
system:

    K_masked = (m m^T) * K + diag(1 - m)

The factorization keeps the reference's jitter escalation: on failure the
noise diagonal is added again, up to `max_retries` more times
(medgpc/src/inference/c_inference_exact.cpp:97-111). The gradient of the
NLML with respect to the gram is the reference's Q-matrix identity
dNLML/dM = 1/2 (M^{-1} - alpha alpha^T) (c_inference_exact.cpp:168-172),
one K4 launch (`NLMLCore`).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from medgp_tpu_torch.models.params import REF_PI
from medgp_tpu_torch.ops import cuda_chol
from medgp_tpu_torch.utils import metrics


def chol_ok(L: torch.Tensor) -> torch.Tensor:
    """(..., n, n) -> (...) bool: every diagonal entry finite and positive."""
    d = torch.diagonal(L, dim1=-2, dim2=-1)
    return torch.all(torch.isfinite(d) & (d > 0.0), dim=-1)


def mask_gram(K: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Zero out padded rows/cols of K (..., n, n) and put 1 on their
    diagonal; mask (..., n) in {0, 1}."""
    Km = K * (mask[..., :, None] * mask[..., None, :])
    # in place on the fresh product: the same sum as JAX's `+ diag(1 - m)`
    # without another (n, n) temporary
    Km.diagonal(dim1=-2, dim2=-1).add_(1.0 - mask)
    return Km


def jittered_chol_solve(
    Km: torch.Tensor,
    y_eff: torch.Tensor,
    noise_eff: torch.Tensor,
    max_retries: int = 10,
):
    """Factor Km + mult * diag(noise_eff) and solve for alpha, per batch
    element, escalating mult = 1, 2, ..., 1 + max_retries on failure
    (ops/nlml.py:_jittered_chol_solve in the JAX package).

    Only the elements that failed are factored again, at the next
    multiplier; each element keeps the first factorization that succeeded,
    which is what JAX's lock-step `while_loop` under vmap gives. An element
    that fails at every multiplier gets L = I, alpha = 0 (and identity
    diagonal-block inverses, so its L^{-1} is I as on the JAX XLA path).
    The systems factored again are counted as `k3.retry_systems`, each
    retry timed as the span `medgp.k3.retry` (utils/metrics.py).

    Returns (L, alpha, linvd, ok, mult)."""
    L, alpha, linvd = cuda_chol.chol_solve(Km, noise_eff, y_eff)
    ok = chol_ok(L)
    mult = torch.ones(Km.shape[0], dtype=torch.int32, device=Km.device)
    m = 1
    while m <= max_retries:
        bad = torch.nonzero(~ok).squeeze(-1)
        if bad.numel() == 0:
            break
        m += 1
        metrics.count("k3.retry_systems", bad.numel())
        with metrics.span("medgp.k3.retry"):
            L2, a2, d2 = cuda_chol.chol_solve(Km[bad], float(m) * noise_eff[bad], y_eff[bad])
            L[bad], alpha[bad], linvd[bad] = L2, a2, d2
            ok[bad] = chol_ok(L2)
            mult[bad] = m
    bad = torch.nonzero(~ok).squeeze(-1)
    if bad.numel():
        n, nb = L.shape[-1], linvd.shape[-1]
        L[bad] = torch.eye(n, dtype=L.dtype, device=L.device)
        alpha[bad] = 0.0
        linvd[bad] = torch.eye(nb, dtype=L.dtype, device=L.device)
    return L, alpha, linvd, ok, mult


class NLMLCore(torch.autograd.Function):
    """(raw NLML, L, alpha, ok, mult) of M = Km + mult * diag(noise_eff),
    batched: Km (B, n, n), y_eff and noise_eff (B, n) -> (B,), (B, n, n),
    (B, n), (B,) bool, (B,) int32 (ops/nlml.py:_nlml_core in the JAX
    package).

    Forward: the retry driver over K3. raw NLML = 1/2 y^T alpha +
    sum log L_ii, accumulated in the inputs' dtype (float32 as JAX with x64
    off, float64 for float64 inputs).

    Backward (unused outputs arrive as None, the stand-in for JAX's
    symbolic zeros):
      * hot path, only d_nlml: one K4 launch,
        dKm = d_nlml / 2 (M^{-1} - alpha alpha^T), dy = d_nlml alpha;
      * with a d_alpha: K5 for L^{-1}, then M^{-1} = L^{-T} L^{-1};
      * with a d_L: the replayed factorization at the chosen multiplier,
        differentiated by `torch.linalg.cholesky` (the cold path);
      * dnoise = mult diag(dKm); every cotangent is 0 where ok is false.
    """

    @staticmethod
    def forward(ctx, Km, y_eff, noise_eff, max_retries):
        ctx.set_materialize_grads(False)
        L, alpha, linvd, ok, mult = jittered_chol_solve(Km, y_eff, noise_eff, max_retries)
        logdet = torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        quad = torch.sum(y_eff * alpha, dim=-1)
        nlml_raw = 0.5 * quad + logdet
        ctx.save_for_backward(Km, noise_eff, L, alpha, linvd, ok, mult)
        ctx.mark_non_differentiable(ok, mult)
        return nlml_raw, L, alpha, ok, mult

    @staticmethod
    def backward(ctx, d_nlml, d_L, d_alpha, _d_ok, _d_mult):
        Km, noise_eff, L, alpha, linvd, ok, mult = ctx.saved_tensors
        if d_nlml is not None and d_alpha is None:
            dKm = cuda_chol.qmat(L, linvd, alpha, 0.5 * d_nlml)
            dy = d_nlml[:, None] * alpha
        else:
            dKm = torch.zeros_like(Km)
            dy = torch.zeros_like(alpha)
        if d_alpha is not None:
            Linv = cuda_chol.tri_inv(L, linvd)
            Kinv = Linv.mT @ Linv
            if d_nlml is not None:
                c = (0.5 * d_nlml)[:, None, None]
                dKm = dKm + c * (Kinv - alpha[:, :, None] * alpha[:, None, :])
                dy = dy + d_nlml[:, None] * alpha
            w = (Kinv @ d_alpha[:, :, None]).squeeze(-1)
            dy = dy + w
            dKm = dKm - w[:, :, None] * alpha[:, None, :]
        m = mult.to(Km.dtype)[:, None]
        dnoise = m * torch.diagonal(dKm, dim1=-2, dim2=-1)
        if d_L is not None:
            with torch.enable_grad():
                Km_ = Km.detach().requires_grad_()
                noise_ = noise_eff.detach().requires_grad_()
                n = Km.shape[-1]
                eye = torch.eye(n, dtype=Km.dtype, device=Km.device)
                Mj = Km_ + torch.diag_embed(m * noise_)
                Mj = torch.where(ok[:, None, None], Mj, eye)
                Lr = torch.linalg.cholesky(Mj)
                dK2, dn2 = torch.autograd.grad(
                    Lr, (Km_, noise_),
                    torch.where(ok[:, None, None], d_L, torch.zeros_like(d_L)),
                )
            dKm = dKm + dK2
            dnoise = dnoise + dn2
        okf = ok.to(Km.dtype)
        return (
            dKm * okf[:, None, None], dy * okf[:, None], dnoise * okf[:, None],
            None,
        )


class NLMLResult(NamedTuple):
    nlml: torch.Tensor   # (B,) negative log marginal likelihood (+inf if not ok)
    ok: torch.Tensor     # (B,) bool success flag
    L: torch.Tensor      # (B, n, n) Cholesky factor
    alpha: torch.Tensor  # (B, n) M^{-1} (y - mean)
    mult: torch.Tensor   # (B,) int32 jitter multiplier used


def masked_nlml(
    K: torch.Tensor,
    y: torch.Tensor,
    noise_var: torch.Tensor,
    mask: torch.Tensor,
    mean: torch.Tensor | None = None,
    max_retries: int = 10,
    pre_masked: bool = False,
) -> NLMLResult:
    """NLML of a padded batch of patients (ops/nlml.py:masked_nlml).

    K (B, n, n) noiseless gram (already carrying mask_gram semantics when
    `pre_masked`), y / noise_var / mask (B, n), optional prior mean (B, n).
    NLML = 1/2 y^T alpha + sum log L_ii + (sum m)/2 log(2 pi); a failed
    factorization reports +inf and ok = False."""
    mask = mask.to(K.dtype)
    y_eff = (y if mean is None else y - mean) * mask
    noise_eff = noise_var * mask
    Km = K if pre_masked else mask_gram(K, mask)
    nlml_raw, L, alpha, ok, mult = NLMLCore.apply(Km, y_eff, noise_eff, max_retries)
    n_eff = torch.sum(mask, dim=-1)
    nlml = nlml_raw + 0.5 * n_eff * math.log(2.0 * REF_PI)
    nlml = torch.where(ok, nlml, torch.full_like(nlml, math.inf))
    return NLMLResult(nlml=nlml, ok=ok, L=L, alpha=alpha, mult=mult)


class Posterior(NamedTuple):
    mean: torch.Tensor  # (B, m) predictive mean
    var: torch.Tensor   # (B, m) predictive variance incl. observation noise


def predict(
    L: torch.Tensor,
    alpha: torch.Tensor,
    Ks: torch.Tensor,
    kss_diag: torch.Tensor,
    noise_var_test: torch.Tensor,
    train_mask: torch.Tensor,
    mean_test: torch.Tensor | None = None,
) -> Posterior:
    """GP posterior at test points from a trained (L, alpha), batched:
    Ks (B, n, m) train-test cross gram, kss_diag and noise_var_test (B, m).

    mean = mean_test + Ks^T alpha; var = kss - ||L^{-1} Ks||_col^2 + noise
    (medgpc/src/core/gp_regression.cpp:128-213 `predict`)."""
    Ks = Ks * train_mask.to(L.dtype)[..., :, None]
    mu = (Ks.mT @ alpha[..., :, None]).squeeze(-1)
    if mean_test is not None:
        mu = mu + mean_test
    V = torch.linalg.solve_triangular(L, Ks, upper=False)
    var = kss_diag - torch.sum(V * V, dim=-2) + noise_var_test
    return Posterior(mean=mu, var=var)
