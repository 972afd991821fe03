"""Hamiltonian Monte Carlo over GP hyperparameters, batched.

Counterpart of ``medgp_tpu/infer/hmc.py``: sample the posterior p(theta | y)
in place of the single MAP point, with

  * a fixed leapfrog budget and uniformly jittered trajectory lengths;
  * dual-averaging step-size adaptation (Hoffman & Gelman 2014) towards a
    target accept statistic, and a diagonal mass matrix estimated in warmup
    (`two_phase_warmup`, shared with NUTS);
  * divergences (energy error > threshold) rejected and counted;
  * clamped hypers (prior type 0) given zero momentum and zero gradient, so
    sparsity-clamped A-elements stay exactly fixed.

The JAX package samples one chain and vmaps over chains and patients. Here
every function takes an explicit batch of rows, one per (patient, chain)
pair: theta (k, H), a step size (k,) and an inverse mass (k, H) per row. A
trajectory is a loop of `max_steps` steps in which each row freezes after
its own step count (`torch.where`), so a transition reads nothing back from
the device, as JAX's `lax.scan` does not.

Randomness comes from the rows' counter-based streams
(:mod:`medgp_tpu_torch.infer.streams`): every draw is a function of the
seed, the patient, the chain, the transition and the draw's purpose, as the
JAX package's per-row keys make it, so a patient's draws do not depend on
its batch mates. The bits differ from `jax.random`'s, so the samplers agree
with the JAX package in distribution and their deterministic parts agree
exactly.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from medgp_tpu_torch.infer import streams as st
from medgp_tpu_torch.models.gp import PatientData, nlml_fn, posterior_at
from medgp_tpu_torch.models.params import KernelSpec
from medgp_tpu_torch.models.priors import PriorSpec

# potential_grad(theta (k, H)) -> (U (k,), dU (k, H))
Potential = Callable[[torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]


class HMCResult(NamedTuple):
    samples: torch.Tensor      # (k, S, H) posterior draws
    potential: torch.Tensor    # (k, S) U(theta) at each draw
    accept_prob: torch.Tensor  # (k, S) per-draw acceptance statistic
    accept_rate: torch.Tensor  # (k,) mean acceptance over the sampling phase
    step_size: torch.Tensor    # (k,) adapted step size
    inv_mass: torch.Tensor     # (k, H) adapted diagonal inverse mass
    divergences: torch.Tensor  # (k,) int32 count during sampling


def _leapfrog(
    potential_grad, theta, p, g, u, eps, inv_mass, n_steps, max_steps, gmask
):
    """Velocity Verlet with a fixed budget of `max_steps` kick-drift-kick
    steps; row i freezes after its own `n_steps[i]` (hmc.py:47-74). `g` and
    `u` are the masked gradient and the potential at `theta`. Returns
    (theta', p', g', U'), where U' is the potential the row's last step
    evaluated at theta': the number JAX's extra evaluation there gives.
    A frozen row is evaluated at its start, whose potential is known to be
    finite, so a diverged trajectory costs no factorization retries."""
    n_steps = torch.as_tensor(n_steps, device=theta.device).expand(theta.shape[0])
    e = eps[:, None]
    theta0 = theta
    for i in range(max_steps):
        active = i < n_steps
        a = active[:, None]
        mom1 = p - 0.5 * e * g
        th1 = theta + e * inv_mass * mom1 * gmask
        u2, g2 = potential_grad(torch.where(a, th1, theta0))
        g2 = g2 * gmask
        mom2 = mom1 - 0.5 * e * g2
        theta = torch.where(a, th1, theta)
        p = torch.where(a, mom2, p)
        g = torch.where(a, g2, g)
        u = torch.where(active, u2, u)
    return theta, p, g, u


class _DAState(NamedTuple):
    log_eps: torch.Tensor
    log_eps_bar: torch.Tensor
    h_bar: torch.Tensor


def _da_update(st: _DAState, accept_prob, i: int, target, mu,
               gamma=0.05, t0=10.0, kappa=0.75):
    """Dual averaging (Hoffman & Gelman 2014, Algorithm 5), per row. The
    iteration's own terms are rounded to float32, as the JAX package
    computes them."""
    f32 = np.float32
    it = f32(i + 1)
    decay = float(f32(1.0) - f32(1.0) / (it + f32(t0)))
    h_bar = decay * st.h_bar + (target - accept_prob) / float(it + f32(t0))
    log_eps = mu - float(np.sqrt(it) / f32(gamma)) * h_bar
    w = it ** f32(-kappa)
    log_eps_bar = float(w) * log_eps + float(f32(1.0) - w) * st.log_eps_bar
    return _DAState(log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar)


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median over the last axis (the mean of the two middle values
    when its length is even), as `jnp.median` computes it."""
    v = torch.sort(x, dim=-1).values
    n = x.shape[-1]
    return (v[..., (n - 1) // 2] + v[..., n // 2]) * 0.5


def two_phase_warmup(
    kernel: Callable,
    state0,
    theta_of: Callable,
    num_warmup: int,
    init_step_size: float,
    target_accept: float,
    gmask: torch.Tensor,
):
    """Shared sampler warmup (hmc.py:96-173), per row: phase 1 adapts the
    step size by dual averaging under identity mass while estimating the
    diagonal mass from its second half (Welford); phase 2 re-adapts the
    step size under the new mass, starting from phase 1's divided by the
    square root of the median inverse mass of the free hypers.

    `kernel(state, eps (k,), inv_mass (k, H)) -> (state, accept_prob (k,))`
    draws from the rows' streams at its own transition count;
    `theta_of(state)` is the (k, H) position.
    Returns (state, eps (k,), inv_mass (k, H))."""
    th0 = theta_of(state0)
    k, H = th0.shape
    dtype, dev = th0.dtype, th0.device
    n1 = max((num_warmup * 3) // 5, 1)
    n2 = max(num_warmup - n1, 0)

    def phase(state, inv_mass, eps_init, collect_from, n_steps):
        zeros = torch.zeros(k, dtype=dtype, device=dev)
        da = _DAState(log_eps=torch.log(eps_init), log_eps_bar=zeros, h_bar=zeros)
        mu = torch.log(10.0 * eps_init)
        mean = torch.zeros(k, H, dtype=dtype, device=dev)
        m2 = torch.zeros_like(mean)
        count = 0.0
        for i in range(n_steps):
            state, accept_prob = kernel(state, torch.exp(da.log_eps), inv_mass)
            da = _da_update(da, accept_prob, i, target_accept, mu)
            if i >= collect_from:
                count += 1.0
                th = theta_of(state)
                delta = th - mean
                mean = mean + delta / max(count, 1.0)
                m2 = m2 + delta * (th - mean)
        eps = torch.exp(da.log_eps_bar)
        eps = torch.where(torch.isfinite(eps) & (eps > 0), eps, eps_init)
        var = m2 / max(count - 1.0, 1.0)
        n_w = max(count, 1.0)
        inv_new = (n_w / (n_w + 5.0)) * var + (5.0 / (n_w + 5.0)) * 1e-3
        inv_new = torch.where(gmask > 0, torch.clamp(inv_new, min=1e-6), 1e-6)
        return state, eps, inv_new

    state, eps1, inv_mass = phase(
        state0, torch.ones(k, H, dtype=dtype, device=dev),
        torch.full((k,), init_step_size, dtype=dtype, device=dev), n1 // 2, n1,
    )
    if n2 == 0:
        return state, eps1, inv_mass
    med = _median(torch.where(gmask > 0, inv_mass, 1.0))
    eps2_init = eps1 / torch.sqrt(torch.clamp(med, min=1e-6))
    state, eps2, _ = phase(state, inv_mass, eps2_init, n2, n2)
    return state, eps2, inv_mass


def free_mask(grad_mask, H, like):
    """1.0 where a hyper may move, 0.0 where clamped, in `like`'s dtype and
    on its device; all ones without a mask."""
    if grad_mask is None:
        return torch.ones(H, dtype=like.dtype, device=like.device)
    return grad_mask.to(like.dtype)


def hmc_sample(
    potential_grad: Potential,
    theta0: torch.Tensor,
    streams: st.Streams,
    num_warmup: int = 200,
    num_samples: int = 200,
    num_leapfrog: int = 16,
    init_step_size: float = 0.01,
    target_accept: float = 0.8,
    jitter_steps: bool = True,
    divergence_threshold: float = 1000.0,
    grad_mask: Optional[torch.Tensor] = None,
) -> HMCResult:
    """Sample exp(-U) for each of the k rows of theta0 (k, H), given
    `potential_grad(theta (k, H)) -> (U (k,), dU (k, H))` (hmc.py:176-260).

    Transition t (warmup and sampling counted together) draws from each
    row's stream at step t: momenta N(0, M) (zero on clamped hypers), a
    step count uniform in 1..num_leapfrog (or num_leapfrog) and the accept
    uniform. It runs the trajectory and accepts with probability
    min(1, exp(-dH)); a non-finite dH counts as +inf and dH >
    divergence_threshold is a divergence, never accepted. Each transition
    evaluates the potential `num_leapfrog` times for all rows; the state
    carries the gradient, so nothing else is evaluated."""
    H, dtype = theta0.shape[1], theta0.dtype
    gmask = free_mask(grad_mask, H, theta0)
    step = 0

    def kernel(state, eps, inv_mass):
        nonlocal step
        theta, u, g = state
        (m0, m1), (s0, _), (a0, _) = st.words(
            streams, step, ((st.HMC_MOMENTUM, H), (st.HMC_STEPS, 1), (st.HMC_ACCEPT, 1))
        )
        step += 1
        p = st.normal(m0, m1, dtype) / torch.sqrt(inv_mass) * gmask
        ke0 = 0.5 * torch.sum(inv_mass * p * p, dim=-1)
        n_steps = 1 + st.below(s0[:, 0], num_leapfrog) if jitter_steps else num_leapfrog
        th2, p2, g2, u2 = _leapfrog(
            potential_grad, theta, p, g, u, eps, inv_mass, n_steps,
            num_leapfrog, gmask,
        )
        ke2 = 0.5 * torch.sum(inv_mass * p2 * p2, dim=-1)
        dH = (u2 + ke2) - (u + ke0)
        dH = torch.where(torch.isfinite(dH), dH, math.inf)
        divergent = dH > divergence_threshold
        accept_prob = torch.where(
            torch.isfinite(dH), torch.clamp(torch.exp(-dH), max=1.0), 0.0
        )
        take = (st.uniform(a0[:, 0], dtype) < accept_prob) & ~divergent
        t = take[:, None]
        state = (
            torch.where(t, th2, theta), torch.where(take, u2, u),
            torch.where(t, g2, g),
        )
        return state, accept_prob, divergent

    u0, g0 = potential_grad(theta0)
    warm, eps, inv_mass = two_phase_warmup(
        lambda s, e, m: kernel(s, e, m)[:2], (theta0, u0, g0 * gmask),
        lambda s: s[0], num_warmup, init_step_size, target_accept, gmask,
    )
    state, draws, pots, aps, divs = warm, [], [], [], []
    for _ in range(num_samples):
        state, ap, div = kernel(state, eps, inv_mass)
        draws.append(state[0])
        pots.append(state[1])
        aps.append(ap)
        divs.append(div)
    aps = torch.stack(aps, dim=1)
    return HMCResult(
        samples=torch.stack(draws, dim=1),
        potential=torch.stack(pots, dim=1),
        accept_prob=aps,
        accept_rate=torch.mean(aps, dim=1),
        step_size=eps,
        inv_mass=inv_mass,
        divergences=torch.sum(torch.stack(divs, dim=1), dim=1, dtype=torch.int32),
    )


def finite_grad(g: torch.Tensor) -> torch.Tensor:
    """The potential's gradient rule (hmc.py:281): each entry that is not
    finite becomes 0, every other entry stays as it is."""
    return torch.where(torch.isfinite(g), g, torch.zeros_like(g))


def make_potential(
    spec: KernelSpec,
    data: PatientData,
    prior: Optional[PriorSpec] = None,
    max_retries: int = 10,
) -> Potential:
    """U(theta) = NLML - log prior over the rows of `data` (hmc.py:263-284):
    +inf where the factorization failed or the patient has <= 2
    observations, so the proposal is rejected rather than crashing the
    batch, with a zero gradient there. The gradient is autograd's through
    `nlml_fn`, with its non-finite entries zeroed (`finite_grad`); the
    prior's `grad_mask` is left to the samplers, which apply it."""
    loss = nlml_fn(spec, data, prior, max_retries)

    def potential_grad(theta):
        with torch.enable_grad():
            th = theta.detach().requires_grad_()
            u, res = loss(th)
            ok = res.ok & (data.n_obs > 2)
            # failed rows enter the sum as 0, so no inf reaches autograd;
            # their gradient is 0, as JAX's `where` gives
            total = torch.where(ok, u, torch.zeros_like(u)).sum()
            (g,) = torch.autograd.grad(total, th)
        return u.detach(), finite_grad(g)

    return potential_grad


def repeat_rows(data: PatientData, times: int) -> PatientData:
    """Each patient's row `times` times in a row: (B, n) -> (B * times, n),
    the (patient, chain) layout of the samplers' batches."""
    return PatientData(*(x.repeat_interleave(times, dim=0) for x in data))


def per_patient(res: NamedTuple, B: int, C: int):
    """A sampler result over B * C rows, with every tensor field's leading
    row axis split into (B, C)."""
    return type(res)(*(
        x.reshape(B, C, *x.shape[1:]) if isinstance(x, torch.Tensor) else x
        for x in res
    ))


def chain_starts(theta0, streams, num_chains, gmask):
    """(B, C, H) chain starts: theta0 (B, C, H) as given, or (B, H) plus a
    0.01 N(0, 1) jitter per chain on the free hypers (hmc.py:300-307),
    drawn from each (patient, chain) stream's START slot; `streams` are
    the B patients'."""
    if theta0.dim() == 3:
        return theta0
    B, H = theta0.shape
    ((w0, w1),) = st.words(st.with_chains(streams, num_chains), 0, ((st.START, H),))
    jitter = 0.01 * st.normal(w0, w1, theta0.dtype).reshape(B, num_chains, H)
    if gmask is not None:
        jitter = jitter * gmask
    return theta0[:, None, :] + jitter


def hmc_patient(
    spec: KernelSpec,
    data: PatientData,
    theta0: torch.Tensor,
    streams: st.Streams,
    prior: Optional[PriorSpec] = None,
    num_chains: int = 4,
    **hmc_kwargs,
) -> HMCResult:
    """Multi-chain HMC for a batch of B patients (data (B, n)), all chains
    of all patients as one batch of rows (hmc.py:287-311). theta0 is (B, H)
    (every chain starts from it, jittered) or (B, C, H); `streams` are the
    B patients' (`streams.patient_streams`), each chain a stream of its
    own. The prior is one (H,) prior shared by the patients. Every tensor
    field of the result leads with (B, C)."""
    gmask = None if prior is None else prior.grad_mask()
    theta0 = chain_starts(theta0, streams, num_chains, gmask)
    B, C, H = theta0.shape
    pg = make_potential(spec, repeat_rows(data, C), prior)
    res = hmc_sample(pg, theta0.reshape(B * C, H), st.with_chains(streams, C),
                     grad_mask=gmask, **hmc_kwargs)
    return per_patient(res, B, C)


def posterior_predict(
    spec: KernelSpec,
    samples: torch.Tensor,
    train: PatientData,
    t2: torch.Tensor,
    meta2: torch.Tensor,
    thin: int = 1,
):
    """Posterior-predictive mixture of one patient at test points
    (hmc.py:314-353): `train` holds that patient's (n,) tensors, samples is
    (S, H), t2 and meta2 (m,).

    Returns (mean (m,), var (m,), nll_fn): the moments of the equally
    weighted Gaussian mixture over the draws, and `nll_fn(y2)`, the
    predictive negative log-likelihood, log-mean-exp over the draws."""
    sub = samples[::thin]
    S = sub.shape[0]
    post = posterior_at(
        spec, sub, PatientData(*(x.expand(S, *x.shape) for x in train)),
        t2.expand(S, *t2.shape), meta2.expand(S, *meta2.shape),
    )
    means, variances = post.mean, post.var  # (S, m)
    mix_mean = torch.mean(means, dim=0)
    mix_var = torch.mean(variances + means**2, dim=0) - mix_mean**2

    def nll_fn(y2):
        lp = (
            -0.5 * (y2[None, :] - means) ** 2 / variances
            - 0.5 * torch.log(2 * math.pi * variances)
        )
        lme = torch.logsumexp(lp, dim=0) - math.log(S)
        return -torch.sum(lme)

    return mix_mean, mix_var, nll_fn
