"""Training of one outlier-large LMC-SM patient by row blocks.

Counterpart of ``medgp_tpu/infer/large_train.py``. The reference's top
Slurm tier trains patients of 10,000 to 100,000 observations as single
100 GB jobs (scripts/slurm_della.json:51-61). Such a patient cannot go
through the padded buckets (one (n, n) float32 gram at n = 100,000 is
40 GB), so the runner routes it here:

  * the observation axis is padded to P row blocks of b rows
    (`utils/hbm.py:large_block_plan`, from the device's free memory, the
    least of any rank's over a mesh), and
    every evaluation walks the blocks (`parallel/mesh.py`), holding L's
    lower block triangle only: on one device, or row-sharded over the
    ranks of a mesh, where every rank runs this function in step on the
    whole patient and holds its own row blocks;
  * the restart screen evaluates cfg.large_patient_restarts inits one
    after another (`large_patient_screen`);
  * SCG, or hier-gamma varEM through its `objective_factory` hook, run
    unchanged over `large_patient_objective`.

The result dict is the one `train_cohort` builds for every patient, so the
runner writes the same train files.
"""

from __future__ import annotations

import numpy as np
import torch

from medgp_tpu_torch.infer.scg import scg_minimize
from medgp_tpu_torch.infer.varem import varem_train
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import LMCSMSpec
from medgp_tpu_torch.parallel.mesh import (
    CohortMesh, large_patient_nlml_diff, large_patient_objective, large_patient_screen,
    min_free_bytes,
)
from medgp_tpu_torch.utils.hbm import device_bytes, large_block_plan


def pad_observations(t: np.ndarray, y: np.ndarray, meta: np.ndarray, multiple: int):
    """Pad the observation axis to a multiple (mask-0 identity rows)."""
    n = len(t)
    n_pad = (-n) % multiple

    def z(a):
        return np.concatenate([a, np.zeros(n_pad, a.dtype)])

    mask = np.concatenate([np.ones(n, np.float32), np.zeros(n_pad, np.float32)])
    return (
        z(t.astype(np.float32)), z(y.astype(np.float32)),
        z(meta.astype(np.int32)), mask,
    )


def train_one_large_patient(
    spec: LMCSMSpec,
    t: np.ndarray,
    y: np.ndarray,
    meta: np.ndarray,
    inits: torch.Tensor,
    prior_mode: int = 2,
    eta: float = 0.01,
    beta_lam: float = 0.01,
    top_iters: int = 40,
    sub_opt_iter: int = 30,
    max_retries: int = 10,
    blocks: int | None = None,
    device: torch.device | str = "cuda",
    mesh: CohortMesh | None = None,
) -> dict:
    """Train one raw (unpadded) patient on `device` by row blocks, over the
    ranks of `mesh` when one is given (each rank calls this with the same
    arguments and gets the same result; `device` is the rank's).

    `inits` is the (S, H) restart set to screen (the caller slices the
    cohort's shared restarts down to cfg.large_patient_restarts);
    `blocks` fixes the number of row blocks P (a multiple of the world),
    else `large_block_plan` takes it from the device's free memory, over
    a mesh the least of any rank's, so that every rank plans the same
    (P, b). Returns the result dict
    `train_cohort` builds per patient: theta, init_theta, flag, loss,
    n_obs and var_state ([psi | delta | phi | tau], or None without the
    hier-gamma prior), and the plan's blocks P and block_rows b."""
    device = torch.device(device)
    n = len(t)
    world = 1 if mesh is None else mesh.world
    free = device_bytes(device) if mesh is None else min_free_bytes(mesh)
    P, b, n_pad = large_block_plan(n, free, spec.Q, blocks, world)
    padded = pad_observations(t, y, meta, n_pad)
    args = tuple(torch.as_tensor(a, device=device) for a in padded)

    # data-quality gate (main_one_train.cpp:186-197), on the host
    counts = np.bincount(np.asarray(meta), minlength=spec.D)
    quality = bool((counts >= 2).all()) and n > 2

    screen = large_patient_screen(spec, P, max_retries, mesh)
    inits = inits.to(device=device, dtype=torch.float32)
    vals, _ = screen(inits, *args)
    values = vals.double().cpu().numpy()
    screen_ok = bool(np.isfinite(values).any())
    theta0 = inits[int(np.argmin(values))]

    base = large_patient_nlml_diff(spec, P, max_retries, mesh)

    def factory(prior):
        return large_patient_objective(
            spec, P, *args, prior=prior, max_retries=max_retries, base=base, mesh=mesh,
        )

    var_flat = None
    if prior_mode == 2:
        data = PatientData(*(a[None] for a in args))
        res = varem_train(
            spec, data, theta0[None], eta=eta, beta_lam=beta_lam,
            outer_iters=top_iters, sub_opt_iter=sub_opt_iter,
            max_retries=max_retries, objective_factory=factory,
        )
        theta, loss, opt_ok = res.theta[0], res.loss[0], res.ok[0]
        var_flat = res.state.flatten()[0].double().cpu().numpy()
    else:
        res = scg_minimize(factory(None), theta0[None], top_iters)
        theta, loss, opt_ok = res.x[0], res.fx[0], res.ok[0]

    loss = float(loss)
    flag = quality and screen_ok and bool(opt_ok) and np.isfinite(loss)
    return dict(
        theta=theta.double().cpu().numpy() if flag else np.zeros(spec.n_hyp),
        init_theta=theta0.double().cpu().numpy(),
        flag=flag,
        loss=loss if flag else float("inf"),
        n_obs=n,
        var_state=var_flat,
        blocks=P,
        block_rows=b,
    )
