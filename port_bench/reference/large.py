"""The reference's objective of one long patient, its gradient and its NLML,
with the dense matrices assembled by row blocks.

`lmcsm.objective_and_grad` builds every (n, n) intermediate of the gram
at once and keeps them for autograd, and factors by a recursion that
copies the trailing matrix at every level: at n = 16,384 in float64 that
is hundreds of GB. Here the same arithmetic is laid out to fit one card:

  * the system matrix M (`lmcsm.system`: gram, jitter multiplier times
    the noise variances on the diagonal, identity on masked rows) is
    filled ROWS rows at a time from `lmcsm.gram`'s cross gram of those
    rows against all;
  * M is factored in place by BLOCK-wide blocks, each diagonal block by
    `cholesky_ex` and each trailing update a matrix product (where a
    lower matmul precision shows, as in `lmcsm.cholesky`);
  * the gradient is the Q-matrix identity: dNLML/dM = (M^-1 - a a^T) / 2,
    a = M^-1 y, pulled back to theta through each block of rows of M by
    `torch.autograd.grad` (M is symmetric and every entry is in one block
    of rows), plus the log prior's gradient (`lmcsm.log_prior`), with the
    clamped hypers held at zero as in `lmcsm.objective_and_grad`.

One patient at a time: theta (1, H), data (1, n). Everything runs in the
dtype of theta. Imports nothing of the measured program.
"""

from __future__ import annotations

import math

import torch

from reference import lmcsm

ROWS = 1024   # rows of M built at once
BLOCK = 512   # width of the factorization's diagonal blocks


def system_rows(theta, t, meta, mask, Q, D, R, mult, lo, hi):
    """Rows lo:hi of `lmcsm.system`'s matrix, (1, hi - lo, n)."""
    m = mask.to(theta.dtype)
    K = lmcsm.gram(theta, t[:, lo:hi], meta[:, lo:hi], Q, D, R, t, meta)
    nv = torch.gather(lmcsm.unpack(theta, Q, D, R)["noise_std"], 1, meta[:, lo:hi].long()) ** 2
    M = K * m[:, lo:hi, None] * m[:, None, :]
    diag = torch.zeros_like(M)
    i = torch.arange(hi - lo, device=M.device)
    diag[:, i, lo + i] = mult[:, None] * nv * m[:, lo:hi] + (1.0 - m[:, lo:hi])
    return M + diag


def _factor(theta, t, meta, mask, Q, D, R, mult):
    """(L (n, n) lower, ok) of the system matrix, built by rows and
    factored in place."""
    n = t.shape[1]
    with torch.no_grad():
        M = torch.empty((n, n), dtype=theta.dtype, device=theta.device)
        for lo in range(0, n, ROWS):
            hi = min(lo + ROWS, n)
            M[lo:hi] = system_rows(theta, t, meta, mask, Q, D, R, mult, lo, hi)[0]
        ok = True
        for k in range(0, n, BLOCK):
            e = min(k + BLOCK, n)
            Lkk, info = torch.linalg.cholesky_ex(M[k:e, k:e])
            ok = ok and int(info) == 0
            M[k:e, k:e] = Lkk
            if e < n:
                panel = torch.linalg.solve_triangular(Lkk, M[e:, k:e].mT, upper=False).mT
                M[e:, k:e] = panel
                M[e:, e:].addmm_(panel, panel.mT, alpha=-1.0)
        return M.tril_(), ok


def _solve(L, y, mask):
    """(a = M^-1 (y mask), NLML) from the factor L."""
    ym = (y.to(L.dtype) * mask.to(L.dtype))[0]
    a = torch.cholesky_solve(ym[:, None], L)[:, 0]
    n = mask.to(L.dtype).sum()
    val = 0.5 * (ym * a).sum() + torch.log(torch.diagonal(L)).sum() \
        + 0.5 * n * math.log(2 * lmcsm.REF_PI)
    return a, val


def nlml(theta, t, y, meta, mask, Q, D, R, mult=None):
    """(NLML (1,), ok (1,)) as `lmcsm.nlml`."""
    mult = theta.new_ones(1) if mult is None else mult
    L, ok = _factor(theta, t, meta, mask, Q, D, R, mult)
    _, val = _solve(L, y, mask)
    return val.reshape(1), torch.tensor([ok], device=theta.device)


def objective_and_grad(theta, t, y, meta, mask, Q, D, R, prior=None, mult=None):
    """(value (1,), gradient (1, H), ok (1,)) as `lmcsm.objective_and_grad`."""
    mult = theta.new_ones(1) if mult is None else mult
    L, ok = _factor(theta, t, meta, mask, Q, D, R, mult)
    a, val = _solve(L, y, mask)
    W = torch.cholesky_inverse(L)
    del L
    W.addr_(a, a, alpha=-1.0).mul_(0.5)
    th = theta.detach().clone().requires_grad_()
    g = torch.zeros_like(th)
    n = t.shape[1]
    with torch.enable_grad():
        for lo in range(0, n, ROWS):
            hi = min(lo + ROWS, n)
            rows = system_rows(th, t, meta, mask, Q, D, R, mult, lo, hi)
            g += torch.autograd.grad(rows, th, W[None, lo:hi])[0]
        if prior is not None:
            lp = lmcsm.log_prior(th, prior)
            val = val - lp.detach()[0]
            g -= torch.autograd.grad(lp.sum(), th)[0]
    if prior is not None:
        g = torch.where(prior["active"] & (prior["ptype"] == lmcsm.PRIOR_CLAMP), 0 * g, g)
    ok_t = torch.tensor([ok], device=theta.device)
    return val.reshape(1), torch.where(ok_t[:, None], g, 0 * g), ok_t
