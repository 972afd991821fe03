"""MAP training of a padded batch of patients: restart screen + optimizer.

Counterpart of ``medgp_tpu/infer/map_train.py`` (the reference's train
driver, medgpc/src/main_one_train.cpp:154-324), with the patients of a
bucket as an explicit batch dimension where JAX vmaps:
  1. data-quality gate: >= 2 observations per output
     (main_one_train.cpp:186-197);
  2. screen the random restarts by NLML without gradients and keep each
     patient's argmin (main_one_train.cpp:228-258): K1 + K3 only, under
     `torch.no_grad()`, in chunks of (restart, patient) systems sized by
     utils/hbm.py;
  3. optimize: hier-gamma prior (mode 2) -> varEM, otherwise (mode 0)
     plain SCG (main_one_train.cpp:270-292).
As in the JAX package, failed restarts are dropped rather than failing the
patient; a patient fails only when every restart does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from medgp_tpu_torch.infer.scg import scg_minimize
from medgp_tpu_torch.infer.varem import VarEMState, varem_train
from medgp_tpu_torch.models.gp import PatientData, nlml_fn, objective_and_grad
from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec
from medgp_tpu_torch.utils import metrics
from medgp_tpu_torch.utils.hbm import screen_chunk_systems


class ScreenResult(NamedTuple):
    best_theta: torch.Tensor  # (P, H) argmin-NLML initialization
    best_loss: torch.Tensor   # (P,)
    n_ok: torch.Tensor        # (P,) restarts that evaluated successfully
    ok: torch.Tensor          # (P,) bool


def data_quality_ok(data: PatientData, n_outputs: int) -> torch.Tensor:
    """(P,) bool: >= 2 observations per output (main_one_train.cpp:186-197)."""
    P = data.t.shape[0]
    counts = torch.zeros((P, n_outputs), dtype=torch.int32, device=data.t.device)
    counts.scatter_add_(1, data.meta.long(), data.mask.to(torch.int32))
    return torch.all(counts >= 2, dim=1)


def screen_inits(
    spec: KernelSpec,
    data: PatientData,
    thetas: torch.Tensor,
    max_retries: int = 10,
) -> ScreenResult:
    """Value-only NLML of every (patient, restart) pair, thetas (S, H),
    in chunks sized by utils/hbm.py's screen budget; each patient keeps
    its first argmin. The call is the span `medgp.train.screen`
    (utils/metrics.py)."""
    with metrics.span("medgp.train.screen"):
        P, n = data.t.shape
        S = thetas.shape[0]
        dev = data.t.device
        chunk = screen_chunk_systems(n, dev)
        values = torch.empty(P * S, dtype=thetas.dtype, device=dev)
        oks = torch.empty(P * S, dtype=torch.bool, device=dev)
        with torch.no_grad():
            for start in range(0, P * S, chunk):
                j = torch.arange(start, min(start + chunk, P * S), device=dev)
                v, res = nlml_fn(spec, data.rows(j // S), None, max_retries)(
                    thetas[j % S]
                )
                values[j], oks[j] = v, res.ok
        values = values.reshape(P, S)
        oks = oks.reshape(P, S)
        values = torch.where(oks, values, torch.full_like(values, float("inf")))
        best = torch.argmin(values, dim=1)
        return ScreenResult(
            best_theta=thetas[best],
            best_loss=values.gather(1, best[:, None]).squeeze(1),
            n_ok=oks.sum(dim=1).to(torch.int32),
            ok=oks.any(dim=1),
        )


class TrainResult(NamedTuple):
    theta: torch.Tensor       # (P, H) trained hypers (train_hyp_*.bin)
    loss: torch.Tensor        # (P,)
    init_theta: torch.Tensor  # (P, H) best restart (train_init_hyp_*.bin)
    var_state: VarEMState     # varEM state (train_var_hyp_*.bin)
    flag: torch.Tensor        # (P,) bool success (train_flag_*.txt)
    n_obs: torch.Tensor       # (P,) int32 (train_num_*.txt)
    n_evals: torch.Tensor     # (P,) int32 objective+gradient evaluations


def train_one_patient(
    spec: KernelSpec,
    data: PatientData,
    init_thetas: torch.Tensor,
    prior_mode: int = 0,
    eta: float = 50.0,
    beta_lam: float = 0.5,
    top_iters: int = 100,
    sub_opt_iter: int = 30,
    max_retries: int = 10,
) -> TrainResult:
    """Full training of every patient of the padded batch `data` (P, n)
    from the shared restart set `init_thetas` (S, H); each patient is
    trained as the JAX package's single-patient function trains it."""
    P = data.t.shape[0]
    dtype, dev = init_thetas.dtype, data.t.device
    n_outputs = spec.D if isinstance(spec, LMCSMSpec) else 1
    quality = data_quality_ok(data, n_outputs)
    screen = screen_inits(spec, data, init_thetas, max_retries)

    if prior_mode == 2:
        if not isinstance(spec, LMCSMSpec):
            raise ValueError("hier-gamma prior requires the LMC-SM kernel")
        res = varem_train(
            spec, data, screen.best_theta, eta=eta, beta_lam=beta_lam,
            outer_iters=top_iters, sub_opt_iter=sub_opt_iter,
            max_retries=max_retries,
        )
        theta, loss, var_state, opt_ok = res.theta, res.loss, res.state, res.ok
        n_evals = res.n_evals
    else:
        f = objective_and_grad(spec, data, None, max_retries)
        sres = scg_minimize(f, screen.best_theta, top_iters)
        theta, loss, opt_ok, n_evals = sres.x, sres.fx, sres.ok, sres.n_evals
        if isinstance(spec, LMCSMSpec):
            var_state = VarEMState.initial(spec, P, dtype, dev)
        else:
            empty = torch.zeros((P, 0), dtype=dtype, device=dev)
            var_state = VarEMState(empty, empty, empty, empty)

    flag = quality & screen.ok & opt_ok & torch.isfinite(loss)
    return TrainResult(
        theta=torch.where(flag[:, None], theta, torch.zeros_like(theta)),
        loss=torch.where(flag, loss, torch.full_like(loss, float("inf"))),
        init_theta=screen.best_theta,
        var_state=var_state,
        flag=flag,
        n_obs=data.n_obs.to(torch.int32),
        n_evals=n_evals,
    )
