"""Mean-field variational inference (ADVI) over GP hyperparameters, batched.

Counterpart of ``medgp_tpu/infer/vi.py``: fit q(theta) = N(m, diag(s^2)) to
exp(-U(theta)) over the unconstrained hyper vector the MAP and sampler
paths use, so the hierarchical-gamma prior, clamping and every consumer of
the posterior mean are shared.

  * The ELBO gradient is the reparameterization estimator, theta = m + s*eps,
    averaged over `num_mc` draws per step. One ADVI step is ONE objective
    batch over (row x draw) pairs: the potential's data holds each row's
    patient `num_mc` times in a row.
  * Adam (b1 0.9, b2 0.999) for a fixed number of steps, per row.
  * Clamped hypers keep q degenerate at theta0: zero gradient through the
    mask and log s pinned at LOG_S_CLAMP.
  * Draws whose objective is not finite (a failed factorization) are masked
    out of the step's average.
  * Step i's Monte Carlo draws come from each row's stream at step i, the
    final draws from its VI_DRAWS slot (:mod:`medgp_tpu_torch.infer.streams`).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from medgp_tpu_torch.infer import streams as st
from medgp_tpu_torch.infer.hmc import Potential, free_mask, make_potential, repeat_rows
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import KernelSpec
from medgp_tpu_torch.models.priors import PriorSpec

# q's log-std for clamped coordinates: effectively a point mass, but large
# enough that exp(2x) stays a normal fp32 number inside the entropy term.
LOG_S_CLAMP = -20.0


class VIResult(NamedTuple):
    mean: torch.Tensor        # (k, H) variational posterior mean
    log_std: torch.Tensor     # (k, H) variational posterior log-std
    samples: torch.Tensor     # (k, S, H) draws from the fitted q
    elbo: torch.Tensor        # (k,) mean MC ELBO over the last quarter
    elbo_trace: torch.Tensor  # (k, num_steps) per-step MC ELBO estimates
    converged: torch.Tensor   # (k,) bool: trace finite over the last quarter


def elbo_and_grad(
    potential_grad: Potential,
    m: torch.Tensor,
    log_s: torch.Tensor,
    eps: torch.Tensor,
    gmask: torch.Tensor,
):
    """MC ELBO and its reparameterization gradient for each of the k rows
    of m and log_s (k, H) from draws `eps` (k, K, H) (vi.py:54-94).
    `potential_grad` takes the k*K thetas, row-major.

    ELBO(m, s) = -E_q[U] + sum(log s) + H/2 (1 + log 2 pi) over the free
    hypers; the entropy's gradient is exact (1/s), only the energy term is
    estimated. Returns (elbo (k,), dm (k, H), dlog_s (k, H)), with
    non-finite draws masked out of the average and elbo -inf where every
    draw failed."""
    k, K, H = eps.shape
    s = torch.exp(log_s)[:, None, :]
    theta = m[:, None, :] + s * eps * gmask
    u, g = potential_grad(theta.reshape(k * K, H))
    u, g = u.reshape(k, K), g.reshape(k, K, H)
    ok = torch.isfinite(u)
    u = torch.where(ok, u, 0.0)
    g = torch.where(ok[..., None], g, 0.0)
    # d(-U)/dm = -g ; d(-U)/dlog_s = -g * s * e (chain rule through
    # theta = m + exp(log_s) * e)
    n_ok = torch.clamp(torch.sum(ok.to(m.dtype), dim=1), min=1.0)
    energy = -torch.sum(u, dim=1) / n_ok
    dm = torch.sum(-g, dim=1) / n_ok[:, None]
    dlog_s = torch.sum(-g * s * eps, dim=1) / n_ok[:, None]

    n_free = torch.sum(gmask, dim=-1)
    entropy = torch.sum(log_s * gmask, dim=-1) + 0.5 * n_free * (
        1.0 + math.log(2.0 * math.pi)
    )
    elbo = energy + entropy
    dm = dm * gmask
    dlog_s = (dlog_s + 1.0) * gmask  # +1 = exact entropy gradient wrt log_s
    elbo = torch.where(torch.any(ok, dim=1), elbo, -math.inf)
    return elbo, dm, dlog_s


def advi_fit(
    potential_grad: Potential,
    theta0: torch.Tensor,
    streams: st.Streams,
    num_steps: int = 400,
    num_mc: int = 4,
    num_samples: int = 200,
    learning_rate: float = 0.02,
    init_log_std: float = -3.0,
    grad_mask: Optional[torch.Tensor] = None,
) -> VIResult:
    """Fit N(m, diag(s^2)) to exp(-U) for each of the k rows of theta0
    (k, H), which initializes m, by maximizing the MC ELBO with Adam
    (vi.py:97-159). `potential_grad` takes (k * num_mc, H) thetas, each
    row's draws in a row. log s is clipped to [LOG_S_CLAMP, 5]."""
    k, H = theta0.shape
    dtype, dev = theta0.dtype, theta0.device
    gmask = free_mask(grad_mask, H, theta0)
    log_s = torch.where(gmask > 0, init_log_std, LOG_S_CLAMP).to(dtype).expand(k, H)
    m = theta0
    b1, b2, adam_eps = 0.9, 0.999, 1e-8
    mom = torch.zeros(k, 2 * H, dtype=dtype, device=dev)
    vel = torch.zeros_like(mom)
    trace = []
    for i in range(num_steps):
        ((w0, w1),) = st.words(streams, i, ((st.VI_EPS, num_mc * H),))
        eps = st.normal(w0, w1, dtype).reshape(k, num_mc, H)
        elbo, dm, dls = elbo_and_grad(potential_grad, m, log_s, eps, gmask)
        g = torch.cat([dm, dls], dim=-1)  # ascend: Adam on -ELBO's gradient
        g = torch.where(torch.isfinite(elbo)[:, None], -g, 0.0)
        mom = b1 * mom + (1 - b1) * g
        vel = b2 * vel + (1 - b2) * g * g
        it = i + 1.0
        mhat = mom / (1 - b1**it)
        vhat = vel / (1 - b2**it)
        upd = learning_rate * mhat / (torch.sqrt(vhat) + adam_eps)
        m = m - upd[:, :H] * gmask
        log_s = torch.clamp(log_s - upd[:, H:] * gmask, LOG_S_CLAMP, 5.0)
        trace.append(elbo)

    trace = torch.stack(trace, dim=1)
    tail = trace[:, -max(num_steps // 4, 1):]
    finite = torch.isfinite(tail)
    ((w0, w1),) = st.words(streams, 0, ((st.VI_DRAWS, num_samples * H),))
    draws = st.normal(w0, w1, dtype).reshape(k, num_samples, H)
    return VIResult(
        mean=m, log_std=log_s,
        samples=m[:, None, :] + torch.exp(log_s)[:, None, :] * draws * gmask,
        elbo=torch.mean(torch.where(finite, tail, 0.0), dim=1),
        elbo_trace=trace,
        converged=torch.all(finite, dim=1),
    )


def vi_patient(
    spec: KernelSpec,
    data: PatientData,
    theta0: torch.Tensor,
    streams: st.Streams,
    prior: Optional[PriorSpec] = None,
    num_mc: int = 4,
    **vi_kwargs,
) -> VIResult:
    """ADVI posterior for a batch of B patients (data (B, n), theta0
    (B, H)) over the MAP/HMC potential (vi.py:162-175), one stream per
    patient; the result's fields lead with B."""
    pg = make_potential(spec, repeat_rows(data, num_mc), prior)
    gmask = None if prior is None else prior.grad_mask()
    return advi_fit(pg, theta0, streams, num_mc=num_mc, grad_mask=gmask, **vi_kwargs)
