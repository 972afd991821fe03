"""No-U-Turn Sampler with iterative tree building, batched.

Counterpart of ``medgp_tpu/infer/nuts.py`` (Phan & Pradhan's iterative
scheme; Hoffman & Gelman 2014 Algorithm 6 with multinomial leaf sampling):

  * a doubling loop whose subtree builder is an inner loop over at most
    2^depth leaves;
  * sub-subtree U-turn checks on a checkpoint stack of momenta and momentum
    sums: a leaf with in-subtree index n stores a checkpoint at slot
    popcount(n) when n is even, and when n is odd checks the spans
    [n - 2^k + 1, n] for k = 1..trailing_ones(n), the binary subtrees that
    leaf n completes;
  * multinomial sampling of the leaves inside a subtree, and biased
    progressive sampling across doublings: a finished subtree's proposal
    replaces the tree's with probability min(1, w_subtree / w_tree);
  * a divergent leaf is never proposed, and a diverging or turning subtree
    is never taken; either stops the doubling;
  * the warmup of :mod:`medgp_tpu_torch.infer.hmc`, under a depth cap of
    `warmup_max_depth`, and a sampling depth cap at the warmup's
    `depth_quantile` depth + 1;
  * clamped hypers carry zero momentum and zero drift.

JAX runs the two loops as `lax.while_loop`s under `vmap`: a member whose
condition is false keeps its state, and a loop runs until no member is
active. Here the rows (patient, chain) are an explicit batch with an active
mask per row and arrays of fixed shape (the checkpoint stacks are
(k, max_depth, H)); the potential is evaluated for every row at every leaf,
as under vmap, and rows that are done are evaluated at the draw's start and
their results discarded. Every row active at doubling d has depth d, so its
subtree has 2^d leaves. Each loop's "any row active" test is one read from
the device; `NUTSResult.host_reads` counts them.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from medgp_tpu_torch.infer.hmc import (
    Potential, chain_starts, free_mask, make_potential, per_patient, repeat_rows,
    two_phase_warmup,
)


class NUTSResult(NamedTuple):
    samples: torch.Tensor      # (k, S, H) posterior draws
    potential: torch.Tensor    # (k, S) U(theta) at each draw
    accept_prob: torch.Tensor  # (k, S) mean leaf acceptance statistic per draw
    accept_rate: torch.Tensor  # (k,) mean over the sampling phase
    step_size: torch.Tensor    # (k,) adapted step size
    inv_mass: torch.Tensor     # (k, H) adapted diagonal inverse mass
    divergences: torch.Tensor  # (k,) int32 count during sampling
    tree_depth: torch.Tensor   # (k, S) int32 depth reached per draw
    n_leapfrog: torch.Tensor   # (k, S) int32 gradient evaluations per draw
    host_reads: int            # "any row active" reads, warmup included


# -------------------------------------------------------------------------
# bit helpers (bit width = max tree depth)
# -------------------------------------------------------------------------

def _bits(n: torch.Tensor, nbits: int) -> torch.Tensor:
    return (n[..., None] >> torch.arange(nbits, dtype=n.dtype, device=n.device)) & 1


def popcount(n: torch.Tensor, nbits: int) -> torch.Tensor:
    return torch.sum(_bits(n, nbits), dim=-1)


def trailing_ones(n: torch.Tensor, nbits: int) -> torch.Tensor:
    return torch.sum(torch.cumprod(_bits(n, nbits), dim=-1), dim=-1)


def is_turning(r_left, r_right, rho, inv_mass) -> torch.Tensor:
    """Generalized U-turn criterion (Betancourt): the trajectory's momentum
    sum `rho` makes negative progress along either endpoint's velocity."""
    v_left = inv_mass * r_left
    v_right = inv_mass * r_right
    return (torch.sum(v_left * rho, dim=-1) <= 0) | (torch.sum(v_right * rho, dim=-1) <= 0)


def ckpt_update_and_check(n: int, r, rho_sub, r_ckpts, rho_ckpts, inv_mass, max_depth: int):
    """One leaf's checkpoint bookkeeping inside a subtree (nuts.py:77-109):
    n is the leaf's in-subtree index, the same for every row; r and
    `rho_sub` (the momentum sum inclusive of leaf n) are (..., H), the
    checkpoint stacks (..., max_depth, H). Returns (r_ckpts, rho_ckpts,
    turning (...)): even leaves store, odd leaves check every binary
    subtree they complete."""
    n_t = torch.tensor(n)
    pc = int(popcount(n_t, max_depth))
    turning = torch.zeros(r.shape[:-1], dtype=torch.bool, device=r.device)
    if n % 2 == 0:
        slot = min(pc, max_depth - 1)
        r_ckpts, rho_ckpts = r_ckpts.clone(), rho_ckpts.clone()
        r_ckpts[..., slot, :] = r
        rho_ckpts[..., slot, :] = rho_sub
        return r_ckpts, rho_ckpts, turning
    for k in range(1, int(trailing_ones(n_t, max_depth)) + 1):
        r_k = r_ckpts[..., max(pc - k, 0), :]
        rho_span = rho_sub - rho_ckpts[..., max(pc - k, 0), :] + r_k
        turning = turning | is_turning(r_k, r, rho_span, inv_mass)
    return r_ckpts, rho_ckpts, turning


# -------------------------------------------------------------------------
# the transition kernel
# -------------------------------------------------------------------------

def _select(active, new: dict, old: dict) -> dict:
    """Per row, `new` where active, else `old`."""
    out = {}
    for key, v in new.items():
        a = active.reshape(active.shape + (1,) * (v.dim() - 1))
        out[key] = torch.where(a, v, old[key])
    return out


def _nuts_transition(
    potential_grad: Potential,
    theta0: torch.Tensor,
    u0: torch.Tensor,
    g0: torch.Tensor,
    gen: torch.Generator,
    eps: torch.Tensor,
    inv_mass: torch.Tensor,
    gmask: torch.Tensor,
    max_depth: int,
    divergence_threshold: float,
    depth_cap=None,
):
    """One NUTS draw for every row (nuts.py:131-331). `depth_cap` (an int or
    (k,)) bounds the doublings below `max_depth`. Returns (theta', u', g',
    accept_stat, divergent, depth, n_leapfrog, host_reads)."""
    k, H = theta0.shape
    dtype, dev = theta0.dtype, theta0.device

    def kinetic(r):
        return 0.5 * torch.sum(inv_mass * r * r, dim=-1)

    def uniform():
        return torch.rand(k, generator=gen, device=dev, dtype=dtype)

    r0 = torch.randn((k, H), generator=gen, device=dev, dtype=dtype)
    r0 = r0 / torch.sqrt(inv_mass) * gmask
    h0 = u0 + kinetic(r0)
    cap = torch.clamp(
        torch.as_tensor(max_depth if depth_cap is None else depth_cap, device=dev),
        max=max_depth,
    )
    reads = 0

    def build_subtree(start, eps_signed, n_leaves, in_tree):
        nonlocal reads
        theta_s, r_s, g_s = start
        false = torch.zeros(k, dtype=torch.bool, device=dev)
        sub = dict(
            theta=theta_s, r=r_s, g=g_s, z_prop=theta_s,
            u_prop=torch.full((k,), math.inf, dtype=dtype, device=dev), g_prop=g_s,
            log_w=torch.full((k,), -math.inf, dtype=dtype, device=dev),
            rho=torch.zeros_like(theta_s), turning=false, diverging=false,
            acc_sum=torch.zeros(k, dtype=dtype, device=dev),
            n_leaf=torch.zeros(k, dtype=torch.int32, device=dev),
            r_ck=torch.zeros(k, max_depth, H, dtype=dtype, device=dev),
            rho_ck=torch.zeros(k, max_depth, H, dtype=dtype, device=dev),
        )
        e = eps_signed[:, None]
        for n in range(n_leaves):
            active = in_tree & ~sub["turning"] & ~sub["diverging"]
            reads += 1
            if not bool(active.any()):
                break
            log_u = torch.log(uniform())
            r_half = sub["r"] - 0.5 * e * sub["g"]
            theta1 = sub["theta"] + e * inv_mass * r_half * gmask
            u1, g1 = potential_grad(torch.where(active[:, None], theta1, theta0))
            g1 = g1 * gmask
            r1 = r_half - 0.5 * e * g1
            dh = (u1 + kinetic(r1)) - h0
            dh = torch.where(torch.isfinite(dh), dh, math.inf)
            diverging = dh > divergence_threshold
            log_w_new = torch.logaddexp(sub["log_w"], -dh)
            take = (log_u < -dh - log_w_new) & ~diverging
            t = take[:, None]
            rho_new = sub["rho"] + r1
            r_ck, rho_ck, turning = ckpt_update_and_check(
                n, r1, rho_new, sub["r_ck"], sub["rho_ck"], inv_mass, max_depth,
            )
            new = dict(
                theta=theta1, r=r1, g=g1,
                z_prop=torch.where(t, theta1, sub["z_prop"]),
                u_prop=torch.where(take, u1, sub["u_prop"]),
                g_prop=torch.where(t, g1, sub["g_prop"]),
                log_w=log_w_new, rho=rho_new, turning=turning, diverging=diverging,
                acc_sum=sub["acc_sum"] + torch.clamp(torch.exp(-dh), max=1.0),
                n_leaf=sub["n_leaf"] + 1, r_ck=r_ck, rho_ck=rho_ck,
            )
            sub = _select(active, new, sub)
        return sub

    false = torch.zeros(k, dtype=torch.bool, device=dev)
    tr = dict(
        z_minus=theta0, r_minus=r0, g_minus=g0, z_plus=theta0, r_plus=r0, g_plus=g0,
        z_prop=theta0, u_prop=u0, g_prop=g0,
        log_w=torch.zeros(k, dtype=dtype, device=dev), rho=r0,
        depth=torch.zeros(k, dtype=torch.int32, device=dev),
        turning=false, diverging=false,
        acc_sum=torch.zeros(k, dtype=dtype, device=dev),
        n_leaf=torch.zeros(k, dtype=torch.int32, device=dev),
    )
    for depth in range(max_depth):
        active = (tr["depth"] < cap) & ~tr["turning"] & ~tr["diverging"]
        reads += 1
        if not bool(active.any()):
            break
        going_right = uniform() < 0.5
        log_u = torch.log(uniform())
        right = going_right[:, None]
        eps_signed = torch.where(going_right, eps, -eps)
        start = (
            torch.where(right, tr["z_plus"], tr["z_minus"]),
            torch.where(right, tr["r_plus"], tr["r_minus"]),
            torch.where(right, tr["g_plus"], tr["g_minus"]),
        )
        sub = build_subtree(start, eps_signed, 1 << depth, active)
        sub_ok = ~sub["turning"] & ~sub["diverging"]

        # biased progressive sampling across the doubling
        log_accept = torch.clamp(sub["log_w"] - tr["log_w"], max=0.0)
        take = sub_ok & (log_u < log_accept)
        t = take[:, None]
        new = dict(
            z_prop=torch.where(t, sub["z_prop"], tr["z_prop"]),
            u_prop=torch.where(take, sub["u_prop"], tr["u_prop"]),
            g_prop=torch.where(t, sub["g_prop"], tr["g_prop"]),
            z_minus=torch.where(right, tr["z_minus"], sub["theta"]),
            r_minus=torch.where(right, tr["r_minus"], sub["r"]),
            g_minus=torch.where(right, tr["g_minus"], sub["g"]),
            z_plus=torch.where(right, sub["theta"], tr["z_plus"]),
            r_plus=torch.where(right, sub["r"], tr["r_plus"]),
            g_plus=torch.where(right, sub["g"], tr["g_plus"]),
            log_w=torch.logaddexp(tr["log_w"], sub["log_w"]),
            rho=tr["rho"] + sub["rho"],
            depth=tr["depth"] + 1,
            diverging=sub["diverging"],
            acc_sum=tr["acc_sum"] + sub["acc_sum"],
            n_leaf=tr["n_leaf"] + sub["n_leaf"],
        )
        merged_turning = is_turning(new["r_minus"], new["r_plus"], new["rho"], inv_mass)
        new["turning"] = sub["turning"] | (sub_ok & merged_turning)
        tr = _select(active, new, tr)

    accept_stat = tr["acc_sum"] / torch.clamp(tr["n_leaf"].to(dtype), min=1.0)
    return (
        tr["z_prop"], tr["u_prop"], tr["g_prop"], accept_stat,
        tr["diverging"], tr["depth"], tr["n_leaf"], reads,
    )


# -------------------------------------------------------------------------
# warmup + sampling loop (mirrors hmc_sample)
# -------------------------------------------------------------------------

def nuts_sample(
    potential_grad: Potential,
    theta0: torch.Tensor,
    gen: torch.Generator,
    num_warmup: int = 200,
    num_samples: int = 200,
    max_depth: int = 6,
    init_step_size: float = 0.01,
    target_accept: float = 0.8,
    divergence_threshold: float = 1000.0,
    grad_mask: Optional[torch.Tensor] = None,
    adapt_depth: bool = True,
    depth_quantile: float = 0.9,
    warmup_max_depth: Optional[int] = 4,
) -> NUTSResult:
    """Sample exp(-U) with NUTS for each of the k rows of theta0 (k, H),
    given `potential_grad(theta (k, H)) -> (U (k,), dU (k, H))`
    (nuts.py:338-441). A draw costs at most 2^max_depth - 1 gradient
    evaluations.

    The warmup doubles at most `warmup_max_depth` times (None: max_depth)
    and records each row's depth histogram; with `adapt_depth` the sampling
    phase doubles at most to that row's `depth_quantile` depth + 1,
    clipped to 1..max_depth, so its depth is at most warmup_max_depth + 1.
    Truncated NUTS remains a valid transition."""
    k, H = theta0.shape
    dtype, dev = theta0.dtype, theta0.device
    gmask = free_mask(grad_mask, H, theta0)
    reads = 0

    def kernel(state, eps, inv_mass, depth_cap):
        nonlocal reads
        theta, u, g = state
        th, u1, g1, acc, div, depth, n_lf, r = _nuts_transition(
            potential_grad, theta, u, g, gen, eps, inv_mass, gmask,
            max_depth, divergence_threshold, depth_cap=depth_cap,
        )
        reads += r
        return (th, u1, g1), acc, div, depth, n_lf

    wcap = None if warmup_max_depth is None else min(warmup_max_depth, max_depth)

    def warm_kernel(wstate, eps, inv_mass):
        state, hist = wstate
        state, acc, _, depth, _ = kernel(state, eps, inv_mass, wcap)
        hist = hist + torch.nn.functional.one_hot(
            torch.clamp(depth, 0, max_depth).long(), max_depth + 1
        ).to(hist.dtype)
        return (state, hist), acc

    u0, g0 = potential_grad(theta0)
    hist0 = torch.zeros(k, max_depth + 1, dtype=torch.int32, device=dev)
    (state, hist), eps, inv_mass = two_phase_warmup(
        warm_kernel, ((theta0, u0, g0 * gmask), hist0), lambda s: s[0][0],
        num_warmup, init_step_size, target_accept, gmask,
    )

    if adapt_depth and num_warmup > 0:
        cum = torch.cumsum(hist, dim=-1).to(torch.float32)
        total = torch.clamp(cum[:, -1:], min=1.0)
        q_depth = torch.argmax((cum >= depth_quantile * total).to(torch.int32), dim=-1)
        depth_cap = torch.clamp(q_depth + 1, 1, max_depth).to(torch.int32)
    else:
        depth_cap = max_depth

    outs = []
    for _ in range(num_samples):
        state, acc, div, depth, n_lf = kernel(state, eps, inv_mass, depth_cap)
        outs.append((state[0], state[1], acc, div, depth, n_lf))
    samples, pots, aps, divs, depths, n_lfs = (torch.stack(x, dim=1) for x in zip(*outs))
    return NUTSResult(
        samples=samples,
        potential=pots,
        accept_prob=aps,
        accept_rate=torch.mean(aps, dim=1),
        step_size=eps,
        inv_mass=inv_mass,
        divergences=torch.sum(divs, dim=1, dtype=torch.int32),
        tree_depth=depths.to(torch.int32),
        n_leapfrog=n_lfs.to(torch.int32),
        host_reads=reads,
    )


def nuts_patient(
    spec,
    data,
    theta0: torch.Tensor,
    gen: torch.Generator,
    prior=None,
    num_chains: int = 4,
    **nuts_kwargs,
) -> NUTSResult:
    """Multi-chain NUTS for a batch of B patients, all chains of all
    patients as one batch of rows; the contract of
    :func:`medgp_tpu_torch.infer.hmc.hmc_patient`."""
    gmask = None if prior is None else prior.grad_mask()
    theta0 = chain_starts(theta0, gen, num_chains, gmask)
    B, C, H = theta0.shape
    pg = make_potential(spec, repeat_rows(data, C), prior)
    res = nuts_sample(pg, theta0.reshape(B * C, H), gen, grad_mask=gmask, **nuts_kwargs)
    return per_patient(res, B, C)
