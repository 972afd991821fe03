"""Gram-matrix construction for the SE / SM / LMC-SM kernel families.

Counterpart of ``medgp_tpu/ops/gram.py`` in plain PyTorch, with an explicit
leading batch dimension in place of vmap. The batched `gram_lmcsm` is the
plain version of the CUDA gram kernel (K1, ops/cuda_gram.py).

Math (reference: medgpc/src/kernel/c_kernel_LMC_SM.cpp):
  * SM base k(r^2; mu, v) = cos(2 pi sqrt(r^2) mu) * exp(-2 (pi v)^2 r^2)
    with PI = 3.14159265 (:374-378);
  * LMC-SM: K_ij = sum_q B_q[meta_i, meta_j] * k_q(r^2_ij) (:152-196);
  * SE: K_ij = s^2 exp(-0.5 ((t_i - t_j) / l)^2) (c_kernel_SE.cpp:72-89);
  * SM: K_ij = sum_q w_q k_q(r^2_ij) (c_kernel_SM.cpp:75-110).
"""

from __future__ import annotations

import torch

from medgp_tpu_torch.models.params import REF_PI


def squared_dist(x: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distance |x_i - x2_j|^2, shape (..., n, m)."""
    d = x[..., :, None] - x2[..., None, :]
    return d * d


def sm_base(rsq: torch.Tensor, mu, v) -> torch.Tensor:
    """cos(2 pi r mu) * exp(-2 (pi v)^2 r^2); mu, v broadcast against rsq."""
    r = torch.sqrt(rsq)
    return torch.cos(2.0 * REF_PI * r * mu) * torch.exp(
        -2.0 * (REF_PI * v) ** 2 * rsq
    )


def gram_se(t: torch.Tensor, lengthscale, scale) -> torch.Tensor:
    """SE self gram, shape (..., n, n)."""
    rsq = squared_dist(t / lengthscale, t / lengthscale)
    return scale**2 * torch.exp(-0.5 * rsq)


def gram_sm(t: torch.Tensor, w, mu, v) -> torch.Tensor:
    """SM self gram: sum_q w_q * k_q; w, mu, v have shape (Q,), or (Bt, Q)
    for one set per patient."""
    rsq = squared_dist(t, t)
    K = torch.zeros_like(rsq)
    for q in range(w.shape[-1]):
        K = K + w[..., q, None, None] * sm_base(
            rsq, mu[..., q, None, None], v[..., q, None, None]
        )
    return K


def gram_lmcsm(
    t: torch.Tensor,
    meta: torch.Tensor,
    B: torch.Tensor,
    mu: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """Batched LMC-SM self gram from the coregional stack
    B_q = A_q A_q^T + diag(kappa_q) (`LMCSMSpec.coregional_B`).

    t (Bt, n) float32, meta (Bt, n) int, B (Bt, Q, D, D), mu and v (Bt, Q)
    -> K (Bt, n, n). Components accumulate one at a time, so peak memory is
    O(n^2) per patient rather than O(Q n^2)."""
    return cross_gram_lmcsm(t, meta, t, meta, B, mu, v)


def cross_gram_lmcsm(t, meta, t2, meta2, B, mu, v) -> torch.Tensor:
    """Batched LMC-SM cross gram K(X, X2): t, meta (Bt, n), t2, meta2
    (Bt, m) -> (Bt, n, m) (c_kernel_LMC_SM.cpp:329-372).

    B_q[meta_i, meta2_j] is taken by one-hot products, the same values as
    a gather (one nonzero term each), whose backward is a matmul: a
    gather's is a scatter-add, whose float atomics on the card sum in
    another order on every run."""
    D = B.shape[-1]
    rsq = squared_dist(t, t2)
    oh = torch.nn.functional.one_hot(meta.long(), D).to(B.dtype)
    oh2 = torch.nn.functional.one_hot(meta2.long(), D).to(B.dtype)
    K = torch.zeros_like(rsq)
    for q in range(B.shape[1]):
        Bmm = (oh @ B[:, q]) @ oh2.mT  # B_q[meta_i, meta2_j]
        K = K + Bmm * sm_base(rsq, mu[:, q, None, None], v[:, q, None, None])
    return K


def diag_lmcsm(meta: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Prior variance diag K(x, x) = sum_q B_q[meta, meta] (k_q(0) = 1),
    meta (Bt, m), B (Bt, Q, D, D) -> (Bt, m) (c_kernel_LMC_SM.cpp:122-150)."""
    diag_d = torch.sum(torch.diagonal(B, dim1=-2, dim2=-1), dim=1)  # (Bt, D)
    return torch.gather(diag_d, 1, meta.long())

