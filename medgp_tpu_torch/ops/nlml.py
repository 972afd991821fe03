"""Masking and the jitter-escalation factorization loop.

Counterpart of the parts of ``medgp_tpu/ops/nlml.py`` that the test stage
runs. Padded rows/columns of a gram are replaced by identity so one batched
factorization serves every padded system:

    K_masked = (m m^T) * K + diag(1 - m)

The factorization keeps the reference's jitter escalation: on failure the
noise diagonal is added again, up to `max_retries` more times
(medgpc/src/inference/c_inference_exact.cpp:97-111).
"""

from __future__ import annotations

import torch

from medgp_tpu_torch.ops import cuda_chol


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
    plain: bool = False,
):
    """Factor Km + mult * diag(noise_eff) and solve for alpha, per batch
    element, escalating mult = 1, 2, ..., 1 + max_retries on failure
    (ops/nlml.py:_jittered_chol_solve in the JAX package).

    Only the elements that failed are factored again, at the next
    multiplier; each element keeps the first factorization that succeeded,
    which is what JAX's lock-step `while_loop` under vmap gives. An element
    that fails at every multiplier gets L = I, alpha = 0 (and identity
    diagonal-block inverses, so its L^{-1} is I as on the JAX XLA path).

    `plain=True` runs the plain twins of the kernels on any device.
    Returns (L, alpha, linvd, ok, mult)."""
    solve = cuda_chol.chol_solve_plain if plain else cuda_chol.chol_solve
    L, alpha, linvd = solve(Km, noise_eff, y_eff)
    ok = chol_ok(L)
    mult = torch.ones(Km.shape[0], dtype=torch.int32, device=Km.device)
    m = 1
    while m <= max_retries:
        bad = torch.nonzero(~ok).squeeze(-1)
        if bad.numel() == 0:
            break
        m += 1
        L2, a2, d2 = solve(Km[bad], float(m) * noise_eff[bad], y_eff[bad])
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
