"""Numpy mirror of the kernel math: the port's independent oracle.

Counterpart of ``medgp_tpu/visualization/fastkernel.py``, copied unchanged
in its math. The reference implements its kernel math a second time in a
small numpy library (medgpc/visualization/fastkernel.py:3-54), which
re-derives B-matrix assembly and the SM response for the clustering and
plotting stages independently of the C++ kernels. This module keeps that
role in the port: plain float64 numpy, with no torch import and nothing
shared with the port's gram code, so it can check the CUDA gram kernel (K1)
and its plain twin, and serve as the host-side math for plotting.

Everything here takes the *flat* hyper vector in the reference pack order
(lik ‖ cov) with cov = [A raw ‖ log mu ‖ log v ‖ log kappa]
(medgpc/src/core/c_hyperparam.cpp:99-122, c_kernel_LMC_SM.cpp:51-70).
"""

from __future__ import annotations

import numpy as np

# The reference's low-precision PI (medgpc/src/util/global_settings.h:6) —
# load-bearing for bit-level parity with the C++ gram.
REF_PI = 3.14159265


def lmcsm_unpack(theta: np.ndarray, Q: int, D: int, R: int):
    """Flat hyper vector -> (noise_var (D,), A (Q,D,R), mu (Q,), v (Q,),
    kappa (Q,D)), natural scale.

    (reference: fastkernel.py:3-31 `get_A_matrix`/`get_B_matrix` +
    c_kernel_LMC_SM.cpp:51-70 selective exp-transform — A elements stay raw.)
    """
    theta = np.asarray(theta, np.float64)
    assert theta.shape[-1] == D + Q * (D * R + 2 + D), theta.shape
    noise_var = np.exp(2.0 * theta[..., :D])
    off = D
    A = theta[..., off : off + Q * D * R].reshape(*theta.shape[:-1], Q, D, R)
    off += Q * D * R
    mu = np.exp(theta[..., off : off + Q])
    off += Q
    v = np.exp(theta[..., off : off + Q])
    off += Q
    kappa = np.exp(theta[..., off : off + Q * D]).reshape(
        *theta.shape[:-1], Q, D
    )
    return noise_var, A, mu, v, kappa


def coregional_B(A: np.ndarray, kappa: np.ndarray) -> np.ndarray:
    """B_q = A_q A_q^T + diag(kappa_q), shape (..., Q, D, D).

    (reference: c_kernel_LMC_SM.cpp:72-115 `compute_coregional_matrix`;
    fastkernel.py:13-31.)
    """
    B = np.einsum("...qdr,...qer->...qde", A, A)
    D = kappa.shape[-1]
    idx = np.arange(D)
    B[..., idx, idx] += kappa
    return B


def squared_dist(x: np.ndarray, x2: np.ndarray) -> np.ndarray:
    """Pairwise squared distance, shape (n, m).

    (reference: fastkernel.py:39-44; c_kernel.cpp:40-63.)
    """
    d = np.asarray(x, np.float64)[:, None] - np.asarray(x2, np.float64)[None, :]
    return d * d


def sm_response(rsq: np.ndarray, mu, v) -> np.ndarray:
    """SM base correlation cos(2 pi r mu) exp(-2 (pi v)^2 r^2).

    (reference: fastkernel.py:33-37; c_kernel_LMC_SM.cpp:374-378
    `compute_k`.)
    """
    r = np.sqrt(rsq)
    return np.cos(2.0 * REF_PI * r * mu) * np.exp(-2.0 * (REF_PI * v) ** 2 * rsq)


def se_response(rsq: np.ndarray, lengthscale, scale) -> np.ndarray:
    """SE response s^2 exp(-rsq / (2 l^2)).

    (reference: fastkernel.py:50-54; c_kernel_SE.cpp:72-89.)
    """
    return scale**2 * np.exp(-0.5 * rsq / lengthscale**2)


def gram_lmcsm(
    theta: np.ndarray,
    t: np.ndarray,
    meta: np.ndarray,
    Q: int,
    D: int,
    R: int,
) -> np.ndarray:
    """Full numpy LMC-SM self gram K_ij = sum_q B_q[meta_i, meta_j] k_q(r^2).

    The independent-oracle version of ops.gram.gram_lmcsm / the CUDA kernel K1
    (reference gram loop: c_kernel_LMC_SM.cpp:152-196).
    """
    _, A, mu, v, kappa = lmcsm_unpack(theta, Q, D, R)
    B = coregional_B(A, kappa)
    meta = np.asarray(meta, np.int64)
    rsq = squared_dist(t, t)
    K = np.zeros_like(rsq)
    for q in range(Q):
        K += B[q][np.ix_(meta, meta)] * sm_response(rsq, mu[q], v[q])
    return K


def gram_sm(theta: np.ndarray, t: np.ndarray, Q: int) -> np.ndarray:
    """Numpy SM self gram sum_q w_q k_q(r^2) from the flat hyper vector
    [log sigma ‖ log w ‖ log mu ‖ log v] (c_kernel_SM.cpp:75-110)."""
    theta = np.asarray(theta, np.float64)
    w = np.exp(theta[1 : 1 + Q])
    mu = np.exp(theta[1 + Q : 1 + 2 * Q])
    v = np.exp(theta[1 + 2 * Q : 1 + 3 * Q])
    rsq = squared_dist(t, t)
    K = np.zeros_like(rsq)
    for q in range(Q):
        K += w[q] * sm_response(rsq, mu[q], v[q])
    return K


def gram_se(theta: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Numpy SE self gram from [log sigma ‖ log l ‖ log s]
    (c_kernel_SE.cpp:72-89)."""
    theta = np.asarray(theta, np.float64)
    return se_response(squared_dist(t, t), np.exp(theta[1]), np.exp(theta[2]))
