"""Plain PyTorch reference of the LMC-SM GP: the objective, its gradient,
the restart set, and the online one-step-ahead loop.

Written from the model's equations (MedGP; medgpc/src/kernel/
c_kernel_LMC_SM.cpp, inference/c_inference_exact.cpp, prior/c_prior.cpp,
main_one_test.cpp), with no kernel, cache or batching scheme of the
measured program, which it does not import. Everything runs in the dtype
of its inputs: float64 for the check, float32 with TF32 on for the
control (the `torch.backends` flags are set by the caller). The gram's
coregional entries are taken by one-hot matrix products and the Cholesky
factor is built by blocks whose trailing updates are matrix products, so
that those products are where a lower matmul precision shows, as it would
in a program that moved them to the tensor cores.

Functions take a leading batch of independent systems, (B, n) data with a
(B, n) {0, 1} mask of the observations that belong to each system: the
masked rows and columns of a system's matrix are the identity, which
leaves its determinant and solves those of the observations alone.

Flat theta: [log noise (D) | A (Q D R) | log mu (Q) | log v (Q) |
log kappa (Q D)]; B_q = A_q A_q^T + diag(kappa_q);
K_ij = sum_q B_q[d_i, d_j] cos(2 pi r mu_q) exp(-2 (pi v_q)^2 r^2), r = |t_i - t_j|;
NLML = y^T M^-1 y / 2 + log det L + n log(2 pi) / 2, M = K + m diag(sigma^2_d),
m the jitter multiplier (1, 2, ... where a factorization failed).
"""

from __future__ import annotations

import math

import numpy as np
import torch

REF_PI = 3.14159265  # the model's own constant (medgpc global_settings.h)
BLOCK = 64

# prior type codes (medgpc/src/prior/c_prior.h)
PRIOR_CLAMP, PRIOR_NORMAL, PRIOR_LAPLACE = 0, 1, 2

# the online loop (main_one_test.cpp:286-309)
WINDOW_HOURS = 72.0
UPDATE_MIN_GAP = 5.0 / 60.0
UPDATE_MIN_INDEX = 3


def unpack(theta, Q, D, R):
    """theta (B, H) -> natural parameters, each with the leading batch."""
    B = theta.shape[0]
    o = D + Q * D * R
    return dict(
        noise_std=torch.exp(theta[:, :D]), A=theta[:, D:o].reshape(B, Q, D, R),
        mu=torch.exp(theta[:, o:o + Q]), v=torch.exp(theta[:, o + Q:o + 2 * Q]),
        kappa=torch.exp(theta[:, o + 2 * Q:o + 2 * Q + Q * D]).reshape(B, Q, D),
    )


def gram(theta, t, meta, Q, D, R, t2=None, meta2=None):
    """Noiseless LMC-SM (cross) gram, (B, n, m)."""
    p = unpack(theta, Q, D, R)
    t2 = t if t2 is None else t2
    meta2 = meta if meta2 is None else meta2
    oh = torch.nn.functional.one_hot(meta.long(), D).to(theta.dtype)
    oh2 = torch.nn.functional.one_hot(meta2.long(), D).to(theta.dtype)
    r = (t[:, :, None] - t2[:, None, :]).abs().to(theta.dtype)
    K = torch.zeros(r.shape, dtype=theta.dtype, device=theta.device)
    for q in range(Q):
        A = p["A"][:, q]
        Bq = A @ A.mT + torch.diag_embed(p["kappa"][:, q])
        kq = torch.cos(2 * REF_PI * r * p["mu"][:, q, None, None]) * torch.exp(
            -2 * (REF_PI * p["v"][:, q, None, None]) ** 2 * r * r)
        K = K + (oh @ Bq @ oh2.mT) * kq
    return K


def cholesky(M):
    """Lower Cholesky factors of M (B, n, n) by blocks of BLOCK rows
    (matrix-product trailing updates), and (B,) whether every pivot of
    each was positive."""
    n = M.shape[-1]
    if n <= BLOCK:
        L, info = torch.linalg.cholesky_ex(M)
        return L, info == 0
    L11, info = torch.linalg.cholesky_ex(M[:, :BLOCK, :BLOCK])
    L21 = torch.linalg.solve_triangular(L11, M[:, BLOCK:, :BLOCK].mT, upper=False).mT
    L22, ok = cholesky(M[:, BLOCK:, BLOCK:] - L21 @ L21.mT)
    top = torch.cat([L11, M.new_zeros((M.shape[0], BLOCK, n - BLOCK))], 2)
    return torch.cat([top, torch.cat([L21, L22], 2)], 1), ok & (info == 0)


def system(theta, t, meta, mask, Q, D, R, mult):
    """The masked system matrix M (B, n, n): the observations' gram plus
    `mult` (B,) times their noise variances, identity on masked rows."""
    K = gram(theta, t, meta, Q, D, R)
    nv = torch.gather(unpack(theta, Q, D, R)["noise_std"], 1, meta.long()) ** 2
    m = mask.to(theta.dtype)
    M = (K + torch.diag_embed(mult[:, None] * nv)) * m[:, :, None] * m[:, None, :]
    return M + torch.diag_embed(1.0 - m)


def nlml(theta, t, y, meta, mask, Q, D, R, mult=None):
    """(NLML (B,), ok (B,)) of each system at its jitter multiplier."""
    if mult is None:
        mult = theta.new_ones(theta.shape[0])
    L, ok = cholesky(system(theta, t, meta, mask, Q, D, R, mult))
    ym = (y.to(theta.dtype) * mask.to(theta.dtype))[:, :, None]
    a = torch.cholesky_solve(ym, L)[:, :, 0]
    n = mask.to(theta.dtype).sum(1)
    val = 0.5 * (ym[:, :, 0] * a).sum(1) \
        + torch.log(torch.diagonal(L, dim1=1, dim2=2)).sum(1) + 0.5 * n * math.log(2 * REF_PI)
    return val, ok


def log_prior(theta, prior):
    """(B,) sum of log densities of the active, unclamped hypers; `prior`
    holds (B, H) or (H,) arrays active, exp_tf, ptype, loc, scale
    (c_prior.cpp:383-421: normal(loc, variance), laplace(loc, b), taken at
    exp(theta) where exp_tf)."""
    h = torch.where(prior["exp_tf"], torch.exp(theta), theta)
    diff = h - prior["loc"]
    normal = prior["ptype"] == PRIOR_NORMAL
    laplace = prior["ptype"] == PRIOR_LAPLACE
    one = torch.ones_like(theta)
    var = torch.where(normal, prior["scale"], one)
    b = torch.where(laplace, prior["scale"], one)
    lp = torch.where(normal, -diff * diff / (2 * var) - 0.5 * torch.log(2 * REF_PI * var), 0 * one)
    lp = lp + torch.where(laplace, -diff.abs() / b - torch.log(2 * b), 0 * one)
    sel = prior["active"] & (prior["ptype"] > PRIOR_CLAMP)
    return torch.where(sel, lp, 0 * one).sum(-1)


def objective_and_grad(theta, t, y, meta, mask, Q, D, R, prior=None, mult=None):
    """(value (B,), gradient (B, H), ok (B,)): NLML minus the log prior,
    and its gradient with the clamped hypers held (zero)."""
    th = theta.detach().clone().requires_grad_()
    with torch.enable_grad():
        v, ok = nlml(th, t, y, meta, mask, Q, D, R, mult)
        if prior is not None:
            v = v - log_prior(th, prior)
        (g,) = torch.autograd.grad(torch.where(ok, v, 0 * v).sum(), th)
    if prior is not None:
        g = torch.where(prior["active"] & (prior["ptype"] == PRIOR_CLAMP), 0 * g, g)
    return v.detach(), g, ok


# ---------------------------------------------------------------------------
# restart set
# ---------------------------------------------------------------------------

def default_bounds(D, Q, R):
    """Reference bounds (opt_prior2.json's, c_experiment.cpp) per flat
    hyper: noise, A, period, lengthscale, lambda."""
    blocks = [((0.15, 0.4), D), ((-1.5, 1.5), Q * D * R), ((12.0, 72.0), Q),
              ((6.0, 72.0), Q), ((0.1, 0.5), Q * D)]
    lb = np.concatenate([np.full(k, lo, np.float32) for (lo, _), k in blocks])
    ub = np.concatenate([np.full(k, hi, np.float32) for (_, hi), k in blocks])
    return lb, ub


def random_inits(seed, Q, D, R, n_inits):
    """(n_inits, H) float32 restart set: 12-bit quantized uniforms on the
    bounds (c_experiment.cpp:500-564), lb + (k + 1) (ub - lb) / 4096, k
    drawn by a CPU torch.Generator seeded with the experiment's seed,
    transformed per block: lik log u; A 0.9/sqrt(Q R) u; mu log(1/u);
    v log(1/(2 pi u)); kappa log(0.1/Q u)."""
    gen = torch.Generator().manual_seed(int(seed))
    lb, ub = (torch.as_tensor(b)[None, :] for b in default_bounds(D, Q, R))
    H = lb.shape[1]
    k = torch.randint(0, 4096, (n_inits, H), generator=gen)
    u = lb + (k + 1).to(torch.float32) * (ub - lb) / 4096
    a_hi = D + Q * D * R
    a_scale = 0.9 / torch.sqrt(torch.tensor(float(Q * R)))
    return torch.cat([
        torch.log(u[:, :D]), a_scale * u[:, D:a_hi],
        torch.log(1.0 / u[:, a_hi:a_hi + Q]),
        torch.log(1.0 / (2.0 * REF_PI * u[:, a_hi + Q:a_hi + 2 * Q])),
        torch.log(0.1 / Q * u[:, a_hi + 2 * Q:]),
    ], dim=1)


# ---------------------------------------------------------------------------
# online one-step-ahead imputation with hyper updates (mean_w_update)
# ---------------------------------------------------------------------------

def loo(theta, t, y, meta, m_S, Q, D, R):
    """Leave-one-out mean and variance of every observation in S (mask
    m_S) from the others in S: with P = M_S^-1, mean_j = y_j - (P y)_j /
    P_jj and var_j = 1 / P_jj. Returns (mean, var, ok), each (B, n)/(B,)."""
    M = system(theta, t, meta, m_S, Q, D, R, theta.new_ones(theta.shape[0]))
    L, ok = cholesky(M)
    P = torch.cholesky_inverse(L)
    d = torch.diagonal(P, dim1=1, dim2=2)
    ym = y.to(theta.dtype) * m_S.to(theta.dtype)
    mean = y.to(theta.dtype) - (P @ ym[:, :, None])[:, :, 0] / d
    return mean, 1.0 / d, ok


def online_with_updates(mode_theta, t, y, meta, mask, Q, D, R, prior, lr, momentum):
    """The online loop of `mean_w_update` for a batch of patients (B, n)
    from one mode kernel (H,): at every unique timestamp u of a patient,
    once its index is past UPDATE_MIN_INDEX and u is more than
    UPDATE_MIN_GAP hours after its last update, one momentum-SGD step on
    the objective of the observations of the 72 h before u (a failed
    objective, or one over 2 observations or fewer, resets theta to the
    mode and the momentum to 0); then each observation at u is predicted
    from the others of that window and of u. A prediction with no other
    observation, or whose factorization failed, is 0 with the mode's
    noise variance. Returns (pred, var, ci) per observation, (B, n)."""
    dt = mode_theta.dtype
    B, n = t.shape
    dev = t.device
    mask = mask.bool()
    theta = mode_theta.to(dt).expand(B, -1).clone()
    delta = torch.zeros_like(theta)
    mode_sd = unpack(mode_theta[None].to(dt), Q, D, R)["noise_std"][0]
    pred = torch.zeros((B, n), dtype=dt, device=dev)
    var = torch.zeros_like(pred)
    ci = torch.zeros((B, n), dtype=torch.int32, device=dev)
    times = [torch.unique(t[b][mask[b]]) for b in range(B)]
    last = torch.stack([u[0] for u in times])
    steps = max(len(u) for u in times)
    for i in range(steps):
        live = [b for b in range(B) if i < len(times[b])]
        u = torch.stack([times[b][i] for b in live])
        lv = torch.as_tensor(live, device=dev)
        tl, yl, ml, kl = t[lv], y[lv], meta[lv], mask[lv]
        win = kl & (tl < u[:, None]) & (u[:, None] - tl <= WINDOW_HOURS)
        if i > UPDATE_MIN_INDEX:
            gate = (u - last[lv]) > UPDATE_MIN_GAP
            if bool(gate.any()):
                g_idx = lv[gate]
                v, g, ok = objective_and_grad(
                    theta[g_idx], tl[gate], yl[gate], ml[gate], win[gate], Q, D, R, prior)
                ok = ok & (win[gate].sum(1) > 2) & torch.isfinite(v) & torch.isfinite(g).all(1)
                d_new = momentum * delta[g_idx] + lr * g
                theta[g_idx] = torch.where(ok[:, None], theta[g_idx] - d_new, mode_theta.to(dt))
                delta[g_idx] = torch.where(ok[:, None], d_new, torch.zeros_like(d_new))
                last[g_idx] = u[gate]
        cur = kl & (tl == u[:, None])
        m_S = win | cur
        mean, v_, ok = loo(theta[lv], tl, yl, ml, m_S, Q, D, R)
        fb = (~ok)[:, None] | ((m_S.sum(1, keepdim=True) <= 1) & cur)
        p_ = torch.where(fb, torch.zeros_like(mean), mean)
        sd = mode_sd[ml.long()]
        v_out = torch.where(fb, sd * sd, v_.clamp(min=0))
        err = (p_ - yl.to(dt)).abs()
        c_ = torch.where(fb, err <= 1.96 * sd, err <= 1.96 * v_.clamp(min=0).sqrt())
        pred[lv] = torch.where(cur, p_, pred[lv])
        var[lv] = torch.where(cur, v_out, var[lv])
        ci[lv] = torch.where(cur, c_.int(), ci[lv])
    return pred, var, ci
