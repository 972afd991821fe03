"""Plain reference of MAP training under the hierarchical-gamma prior: the
restart's scaled-conjugate-gradient M-steps and the closed-form E-steps of
variational EM, one patient at a time.

Written from the algorithms (medgpc/src/util/c_optimizer_scg.cpp, a port
of Rasmussen's minimize.m in its function-evaluation-budget mode, and
c_optimizer_varEM.cpp), with no batching scheme of the measured program,
which it does not import:

  * SCG: cubic extrapolation to bracket a minimum along the search
    direction (a failed evaluation halves the trial step), cubic or
    quadratic interpolation inside the bracket until the Wolfe-Powell
    conditions hold, Polak-Ribiere direction updates, slope-ratio step
    guessing, a restart from the best point seen along steepest descent
    when a line search fails; every evaluation and every outer iteration
    counts against the budget;
  * varEM: the SCG budget `warmup_evals` for the first `warmup_iters`
    rounds, then `sub_opt_iter`; an early stop when the relative change of
    the loss falls under 0.005 (checked after the M-step, before that
    round's E-step, from the second round on); the E-step in the order
    tau, phi, delta, psi, each from the fresh values; an A element whose
    psi is 0 is set to 0 and clamped; the Normal prior's variance on A is
    re-linked to psi.

Each patient's fit is a generator that yields the point it wants
evaluated and receives (value, gradient, ok); `fit` runs all of them in
step, one batched evaluation of the reference objective (`lmcsm.py`) per
step, with the jitter multiplier raised 1, 2, ..., 11 where a
factorization fails. Vectors are kept in the given dtype (float64 for the
check, float32 for the control); the line search's scalars are Python
floats.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from reference import lmcsm

# line-search constants of minimize.m
_INT, _EXT, _MAX, _RATIO, _SIG = 0.1, 3.0, 20, 10.0, 0.1
_RHO = _SIG / 2.0
_EPS = 2.0 ** -52

EARLY_STOP_TOL = 0.005
ALPHA = BETA = GAMMA = DEE = 0.5  # the hier-gamma hyper-priors' fixed shapes
MAX_RETRIES = 10


def _div(a, b):
    """a / b as IEEE float arithmetic gives it: inf or nan where b is 0."""
    with np.errstate(all="ignore"):
        return float(np.float64(a) / np.float64(b))


def scg(x0, max_evals):
    """Generator: minimize from x0 (H,) within `max_evals` evaluations;
    yields a point, is sent (value, gradient, ok); returns (x, value, ok)."""
    dt = x0.dtype

    def dot(a, b):
        return float(np.dot(a.astype(np.float64), b.astype(np.float64)))

    f0, df0, ok0 = yield x0
    i = 1
    X, fX = x0.copy(), f0
    s = -df0
    d0 = -dot(s, s)
    x3 = 1.0 / (1.0 - d0)
    obj_flag = ok0
    while i < max_evals:
        i += 1
        M = min(max_evals - i, _MAX)
        x1 = x2 = 0.0
        f1 = f2 = f3 = fX
        d1 = d2 = d3 = d0
        df3 = df0
        X0, F0, dF0 = X, fX, df0
        while True:  # extrapolation
            success = False
            while not success and M > 0:
                f3, df3, okk = yield (X + x3 * s).astype(dt)
                okk = okk and bool(np.all(np.isfinite(df3)))
                if not okk:
                    x3 = (x2 + x3) / 2.0
                M -= 1
                i += 1
                obj_flag = success = okk
            if f3 < F0:
                X0, F0, dF0 = (X + x3 * s).astype(dt), f3, df3
            d3 = dot(df3, s)
            if d3 > _SIG * d0 or f3 > fX + x3 * _RHO * d0 or M <= 0:
                break
            x1, f1, d1 = x2, f2, d2
            x2, f2, d2 = x3, f3, d3
            A = 6.0 * (f1 - f2) + 3.0 * (d2 + d1) * (x2 - x1)
            B = 3.0 * (f2 - f1) - (2.0 * d1 + d2) * (x2 - x1)
            temp = B * B - A * d1 * (x2 - x1)
            den = B + math.sqrt(max(temp, 0.0))
            cand = x1 - _div(d1 * (x2 - x1) * (x2 - x1), den)
            if temp < 0 or not math.isfinite(cand) or cand < 0:
                cand = x2 * _EXT
            x3 = max(min(cand, x2 * _EXT), x2 + _INT * (x2 - x1))
        x4, f4, d4 = x3, f3, d3
        while (abs(d3) > -_SIG * d0 or f3 > fX + x3 * _RHO * d0) and M > 0:  # interpolation
            if d3 > 0 or f3 > fX + x3 * _RHO * d0:
                x4, f4, d4 = x3, f3, d3
            else:
                x2, f2, d2 = x3, f3, d3
            if f4 > fX:
                den = f4 - f2 - d2 * (x4 - x2)
                x3 = x2 - _div(0.5 * d2 * (x4 - x2) * (x4 - x2), den)
            else:
                A = _div(6.0 * (f2 - f4), x4 - x2) + 3.0 * (d4 + d2)
                B = 3.0 * (f4 - f2) - (2.0 * d2 + d4) * (x4 - x2)
                disc = B * B - A * d2 * (x4 - x2) * (x4 - x2)
                if disc < 0:
                    x3 = (x2 + x4) / 2.0
                else:
                    x3 = x2 + _div(math.sqrt(disc) - B, A)
            if not math.isfinite(x3):
                x3 = (x2 + x4) / 2.0
            x3 = max(min(x3, x4 - _INT * (x4 - x2)), x2 + _INT * (x4 - x2))
            f3, df3, okk = yield (X + x3 * s).astype(dt)
            okk = okk and bool(np.all(np.isfinite(df3)))
            if okk and f3 < F0:
                X0, F0, dF0 = (X + x3 * s).astype(dt), f3, df3
            d3 = dot(df3, s)
            M -= 1
            i += 1
            obj_flag = okk
        if obj_flag and abs(d3) < -_SIG * d0 and f3 < fX + x3 * _RHO * d0:
            X, fX = (X + x3 * s).astype(dt), f3
            s_new = (_div(dot(df3, df3) - dot(df3, df0), dot(df0, df0)) * s - df3).astype(dt)
            d0_new = dot(df3, s_new)
            if d0_new > 0:
                s_new = -df3
                d0_new = -dot(s_new, s_new)
            x3 = x3 * min(_RATIO, _div(d0, d0_new - _EPS))
            df0, s, d0 = df3, s_new, d0_new
        else:
            X, fX, df0 = X0, F0, dF0
            s = -dF0
            d0 = -dot(s, s)
            x3 = 1.0 / (1.0 - d0)
    return X, fX, bool(ok0 or math.isfinite(fX))


def hier_gamma_prior(Q, D, R, beta_lam, dt):
    """The prior before the first E-step, (H,) numpy arrays: A Normal(0,
    variance 1), kappa Laplace(0, beta_lam) on exp(theta), mu and v
    exp-transformed and unregularized, the noise unregularized."""
    H = D + Q * D * R + 2 * Q + Q * D
    a = slice(D, D + Q * D * R)
    mu_v = slice(D + Q * D * R, D + Q * D * R + 2 * Q)
    kappa = slice(D + Q * D * R + 2 * Q, H)
    active = np.zeros(H, bool)
    exp_tf = np.zeros(H, bool)
    ptype = np.full(H, -1, np.int64)
    scale = np.ones(H, dt)
    active[a], ptype[a] = True, lmcsm.PRIOR_NORMAL
    exp_tf[mu_v] = True
    active[kappa], exp_tf[kappa], ptype[kappa] = True, True, lmcsm.PRIOR_LAPLACE
    scale[kappa] = beta_lam
    return dict(active=active, exp_tf=exp_tf, ptype=ptype, loc=np.zeros(H, dt), scale=scale)


def e_step(psi, delta, phi, a, eta):
    """One E-step from the state (psi, delta (Q, D, R), phi (Q, R)) and the
    A block a (Q, D, R): tau, phi, delta, psi in that order, each from the
    fresh values. Returns the new (psi, delta, phi)."""
    D = a.shape[1]
    tau = (GAMMA + DEE) / (phi + eta)
    phi = (D * BETA + GAMMA - 1.0) / (delta.sum(axis=1) + tau)
    delta = (ALPHA + BETA) / (psi + phi[:, None, :])
    s = 2.0 * ALPHA - 3.0
    psi = (s + np.sqrt(s * s + 8.0 * delta * a * a)) / (4.0 * delta)
    return psi.astype(a.dtype), delta.astype(a.dtype), phi.astype(a.dtype)


def varem(theta0, Q, D, R, eta, beta_lam, outer_iters, sub_opt_iter,
          warmup_iters=5, warmup_evals=100):
    """Generator: one patient's varEM fit from theta0 (H,); yields (point,
    prior) to evaluate the objective under, is sent (value, gradient, ok);
    returns (theta, loss, ok)."""
    dt = theta0.dtype
    a_sl = slice(D, D + Q * D * R)
    prior = hier_gamma_prior(Q, D, R, beta_lam, dt)
    psi = np.ones((Q, D, R), dt)
    delta = np.ones((Q, D, R), dt)
    phi = np.ones((Q, R), dt)
    theta, loss, prev, ok = theta0.copy(), math.inf, math.inf, True
    n_warm = min(warmup_iters, outer_iters)
    for it in range(max(outer_iters, n_warm)):
        used = {k: v.copy() for k, v in prior.items()}
        m_step = scg(theta, warmup_evals if it < n_warm else sub_opt_iter)
        x = next(m_step)
        try:
            while True:
                x = m_step.send((yield x, used))
        except StopIteration as stop:
            x, fx, ok_m = stop.value
        ok = ok and ok_m
        loss = fx
        if it > 0 and abs(_div(fx - prev, prev)) < EARLY_STOP_TOL:
            theta = x
            break
        psi, delta, phi = e_step(psi, delta, phi, x[a_sl].reshape(Q, D, R), eta)
        clamp = (psi.reshape(-1) <= 0) | (prior["active"][a_sl] & (prior["ptype"][a_sl] == lmcsm.PRIOR_CLAMP))
        theta = x.copy()
        theta[a_sl] = np.where(clamp, 0, x[a_sl])
        prior["ptype"][a_sl] = np.where(clamp, lmcsm.PRIOR_CLAMP, prior["ptype"][a_sl])
        prior["scale"][a_sl] = psi.reshape(-1)
        prev = fx
    return theta, loss, bool(ok and math.isfinite(loss))


def objective(theta, t, y, meta, mask, Q, D, R, prior):
    """(value, gradient, ok) of a batch, each system at the first jitter
    multiplier 1, 2, ..., 1 + MAX_RETRIES whose factorization succeeds; a
    failed one reads value inf, gradient 0."""
    B = theta.shape[0]
    mult = theta.new_ones(B)
    v, g, ok = lmcsm.objective_and_grad(theta, t, y, meta, mask, Q, D, R, prior, mult)
    for m in range(2, MAX_RETRIES + 2):
        bad = torch.nonzero(~ok).squeeze(-1)
        if bad.numel() == 0:
            break
        pr = {k: x[bad] for k, x in prior.items()}
        vb, gb, okb = lmcsm.objective_and_grad(
            theta[bad], t[bad], y[bad], meta[bad], mask[bad], Q, D, R, pr,
            torch.full((bad.numel(),), float(m), dtype=theta.dtype, device=theta.device))
        v[bad], g[bad], ok[bad] = vb, gb, okb
    ok = ok & torch.isfinite(v) & torch.isfinite(g).all(1)
    v = torch.where(ok, v, torch.full_like(v, math.inf))
    g = torch.where(ok[:, None], g, torch.zeros_like(g))
    return v, g, ok


def fit(inits, patients, Q, D, R, eta, beta_lam, outer_iters, sub_opt_iter, dtype, device):
    """varEM fits of several patients, in `dtype` (float64 or float32; the
    caller sets the TF32 flags): `inits` (P, H) numpy, `patients` a list of
    (t, y, meta) numpy arrays. Returns a list of (theta, loss, ok, prior of
    the last M-step) per patient."""
    npdt = np.float64 if dtype == torch.float64 else np.float32
    P = len(patients)
    n = max(len(p[0]) for p in patients)
    t = torch.zeros((P, n), dtype=dtype)
    y = torch.zeros((P, n), dtype=dtype)
    meta = torch.zeros((P, n), dtype=torch.int64)
    mask = torch.zeros((P, n), dtype=torch.bool)
    for i, (ti, yi, mi) in enumerate(patients):
        k = len(ti)
        t[i, :k] = torch.as_tensor(np.asarray(ti, np.float64)).to(dtype)
        y[i, :k] = torch.as_tensor(np.asarray(yi, np.float64)).to(dtype)
        meta[i, :k], mask[i, :k] = torch.as_tensor(np.asarray(mi, np.int64)), True
    t, y, meta, mask = (x.to(device) for x in (t, y, meta, mask))
    gens = [varem(np.asarray(inits[i], npdt), Q, D, R, eta, beta_lam, outer_iters, sub_opt_iter)
            for i in range(P)]
    out = [None] * P
    want = {}
    for i, g in enumerate(gens):
        want[i] = next(g)
    while want:
        idx = sorted(want)
        th = torch.as_tensor(np.stack([want[i][0] for i in idx])).to(device=device, dtype=dtype)
        pr = {k: torch.as_tensor(np.stack([want[i][1][k] for i in idx])).to(device)
              for k in ("active", "exp_tf", "ptype", "loc", "scale")}
        pr["loc"], pr["scale"] = pr["loc"].to(dtype), pr["scale"].to(dtype)
        sel = torch.as_tensor(idx, device=device)
        v, gr, ok = objective(th, t[sel], y[sel], meta[sel], mask[sel], Q, D, R, pr)
        v, gr, ok = v.cpu().numpy(), gr.cpu().numpy().astype(npdt), ok.cpu().numpy()
        for j, i in enumerate(idx):
            try:
                want[i] = gens[i].send((float(v[j]), gr[j], bool(ok[j])))
            except StopIteration as stop:
                out[i] = stop.value
                del want[i]
    return out
