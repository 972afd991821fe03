"""Variational-EM loop for the hierarchical-gamma sparsity prior, batched.

Counterpart of ``medgp_tpu/infer/varem.py`` (the reference's
medgpc/src/util/c_optimizer_varEM.cpp:26-206): outer EM rounds of SCG
M-steps with closed-form E-step updates of the variational parameters
(psi, delta, phi, tau), exact sparsification by clamping A-elements whose
psi underflows to zero, and re-linking of the Normal(0, psi) prior.

Kept exactly, per batch element (one patient each):
  * SCG budget: `warmup_evals` (100) for the first `warmup_iters` (5)
    rounds, then `sub_opt_iter`;
  * early stop when |(loss - prev_loss) / prev_loss| < 0.005, checked after
    the M-step and before that round's E-step;
  * E-step order tau -> phi -> delta -> psi, each with the fresh values;
  * psi <= PSI_CLAMP_EPS => a := 0 and the element is clamped for the rest
    of the run;
  * per round, a frozen element (stopped earlier) keeps everything, a
    stopping one takes the M-step result and skips the E-step, a
    continuing one takes both (varem.py:202-227).
The JAX package runs every element through every round's SCG and selects;
here only the elements still running are optimized, and the loop ends when
none is, which gives the same results.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from medgp_tpu_torch.infer.scg import scg_minimize
from medgp_tpu_torch.models.gp import PatientData, objective_and_grad
from medgp_tpu_torch.models.params import LMCSMSpec, cov_slices
from medgp_tpu_torch.models.priors import PRIOR_CLAMP, PriorSpec, hier_gamma_prior
from medgp_tpu_torch.utils import metrics

EARLY_STOP_TOL = 0.005  # |relative loss change| that stops (varEM.cpp:89-95)
PSI_CLAMP_EPS = 0.0     # psi at or below it clamps its A element


class VarEMState(NamedTuple):
    """Variational parameters of a batch; the flat layout
    [psi | delta | phi | tau] is the reference's cov_varEM vector of size
    2 Q (D R + R) per patient."""

    psi: torch.Tensor    # (P, Q, D, R)
    delta: torch.Tensor  # (P, Q, D, R)
    phi: torch.Tensor    # (P, Q, R)
    tau: torch.Tensor    # (P, Q, R)

    def flatten(self) -> torch.Tensor:
        """(P, 2 Q (D R + R))."""
        P = self.psi.shape[0]
        return torch.cat([x.reshape(P, -1) for x in self], dim=1)

    def rows(self, idx) -> "VarEMState":
        return VarEMState(*(x[idx] for x in self))

    @classmethod
    def initial(cls, spec: LMCSMSpec, batch: int, dtype=torch.float32,
                device="cpu") -> "VarEMState":
        Q, D, R = spec.Q, spec.D, spec.R
        one = torch.ones((batch, Q, D, R), dtype=dtype, device=device)
        oneqr = torch.ones((batch, Q, R), dtype=dtype, device=device)
        return cls(psi=one, delta=one.clone(), phi=oneqr, tau=oneqr.clone())


class VarEMResult(NamedTuple):
    theta: torch.Tensor    # (P, H)
    loss: torch.Tensor     # (P,)
    state: VarEMState
    prior: PriorSpec       # (P, H) fields
    n_outer: torch.Tensor  # (P,) int32 outer EM rounds actually run
    ok: torch.Tensor       # (P,) bool
    n_evals: torch.Tensor  # (P,) int32 objective+gradient evaluations


def e_step(spec: LMCSMSpec, st: VarEMState, a: torch.Tensor, fixed):
    """One E-step; `a` (P, Q, D, R) is the A block of theta, `fixed` the
    (alpha, beta, gamma, d, eta) hypers. Returns (new_state, clamp mask
    (P, Q, D, R) bool)."""
    alpha, beta, gamma, d, eta = fixed
    tau = (gamma + d) / (st.phi + eta)
    phi = (spec.D * beta + gamma - 1.0) / (torch.sum(st.delta, dim=-2) + tau)
    delta = (alpha + beta) / (st.psi + phi[..., None, :])
    s = 2.0 * alpha - 3.0
    psi = (s + torch.sqrt(s * s + 8.0 * delta * a * a)) / (4.0 * delta)
    return VarEMState(psi=psi, delta=delta, phi=phi, tau=tau), psi <= PSI_CLAMP_EPS


def varem_train(
    spec: LMCSMSpec,
    data: PatientData,
    theta0: torch.Tensor,
    eta: float = 50.0,
    beta_lam: float = 0.5,
    outer_iters: int = 40,
    sub_opt_iter: int = 30,
    warmup_iters: int = 5,
    warmup_evals: int = 100,
    max_retries: int = 10,
    objective_factory=None,
) -> VarEMResult:
    """MAP training of a padded batch of patients (B, n), one theta0 row
    (B, H) each, under the hier-gamma prior with the experiment's `eta`
    and `beta_lam` (c_experiment.cpp:99-110).

    `objective_factory(prior) -> f`, where given, builds each M-step's
    objective in place of `objective_and_grad(spec, data, prior)`
    (varem.py:133,140-170 in the JAX package): `prior` holds the rows of
    the elements still running, and `f` has the batched signature
    `f(theta (k, H), idx=None) -> (value (k,), grad (k, H), ok (k,))`.
    The large-patient path passes `parallel.mesh.large_patient_objective`
    here, with k = 1."""
    P = theta0.shape[0]
    dtype, dev = theta0.dtype, theta0.device
    sl = cov_slices(spec)
    a_lo, a_hi = sl["a"].start, sl["a"].stop
    shape = (spec.Q, spec.D, spec.R)
    fixed = torch.tensor([0.5, 0.5, 0.5, 0.5, eta], dtype=dtype, device=dev)

    prior = hier_gamma_prior(spec, beta_lam, dtype, dev).expand(P)
    state = VarEMState.initial(spec, P, dtype, dev)
    theta = theta0.clone()
    loss = torch.full((P,), float("inf"), dtype=dtype, device=dev)
    prev_loss = loss.clone()
    done = torch.zeros(P, dtype=torch.bool, device=dev)
    n_outer = torch.zeros(P, dtype=torch.int32, device=dev)
    n_evals = torch.zeros(P, dtype=torch.int32, device=dev)
    ok = torch.ones(P, dtype=torch.bool, device=dev)

    n_warm = min(warmup_iters, outer_iters)
    for it in range(max(outer_iters, n_warm)):
        run = torch.nonzero(~done).squeeze(-1)
        if run.numel() == 0:
            break
        with metrics.span("medgp.varem.round"):
            pr = prior.rows(run)
            if objective_factory is not None:
                f = objective_factory(pr)
            else:
                f = objective_and_grad(spec, data.rows(run), pr, max_retries)
            res = scg_minimize(
                f, theta[run], warmup_evals if it < n_warm else sub_opt_iter
            )

            # early stop, checked before the E-step
            change = (res.fx - prev_loss[run]) / prev_loss[run]
            stop = (torch.abs(change) < EARLY_STOP_TOL) & (it > 0)

            with metrics.span("medgp.varem.estep"):
                k = run.numel()
                a = res.x[:, a_lo:a_hi].reshape(k, *shape)
                new_state, clamp = e_step(spec, state.rows(run), a, fixed)
                already = (
                    pr.active[:, a_lo:a_hi] & (pr.ptype[:, a_lo:a_hi] == PRIOR_CLAMP)
                )
                clamp_all = clamp.reshape(k, -1) | already
                theta_new = res.x.clone()
                theta_new[:, a_lo:a_hi] = torch.where(
                    clamp_all, torch.zeros_like(a.reshape(k, -1)), res.x[:, a_lo:a_hi]
                )
                ptype_new = pr.ptype.clone()
                ptype_new[:, a_lo:a_hi] = torch.where(
                    clamp_all, torch.full_like(ptype_new[:, a_lo:a_hi], PRIOR_CLAMP),
                    pr.ptype[:, a_lo:a_hi],
                )
                scale_new = pr.scale.clone()
                scale_new[:, a_lo:a_hi] = new_state.psi.reshape(k, -1).to(dtype)

                # stopping elements keep this round's M-step and skip its E-step
                keep = stop[:, None]
                theta[run] = torch.where(keep, res.x, theta_new)
                state = VarEMState(*(
                    x.index_put((run,), torch.where(
                        stop.reshape(-1, *[1] * (x.dim() - 1)), x[run], nx))
                    for x, nx in zip(state, new_state)
                ))
                prior = prior._replace(
                    ptype=prior.ptype.index_put((run,), torch.where(keep, pr.ptype, ptype_new)),
                    scale=prior.scale.index_put((run,), torch.where(keep, pr.scale, scale_new)),
                )
            loss[run] = res.fx
            prev_loss[run] = res.fx
            done[run] = stop
            n_outer[run] += 1
            n_evals[run] += res.n_evals
            ok[run] = ok[run] & res.ok

    return VarEMResult(
        theta=theta, loss=loss, state=state, prior=prior, n_outer=n_outer,
        ok=ok & torch.isfinite(loss), n_evals=n_evals,
    )
