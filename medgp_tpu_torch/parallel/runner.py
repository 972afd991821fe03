"""Cohort-level train and test stages over padded buckets.

Counterpart of ``medgp_tpu/parallel/runner.py`` (`train_cohort`,
`test_cohort`, `obs_output_order`, `stage_metrics`, `_test_prior`). Each
padded bucket of patients runs as one batched `train_one_patient` or
`online_impute` on one device. The TPU-only parts (pow-2 batch padding to
bound recompiles, the device mesh, the explicit compile step) have no
counterpart here; the row-blocked path for large patients and the
per-bucket checkpoints are not ported yet (ROADMAP A7, A4).
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from medgp_tpu_torch.config.experiment import ExperimentConfig
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import (
    PaddedBatch, PatientRecord, bucket_edges, pack_patients,
)
from medgp_tpu_torch.data.inits import random_inits
from medgp_tpu_torch.infer.map_train import train_one_patient
from medgp_tpu_torch.infer.online import OnlineResult, online_impute, unique_times
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, theta_from_numpy
from medgp_tpu_torch.models.priors import PriorSpec, clamp_a_elements, empty_prior
from medgp_tpu_torch.utils.hbm import train_batch_cap
from medgp_tpu_torch.utils.metrics import MetricsWriter

log = logging.getLogger("medgp_tpu_torch")

TEST_MODES = ("mean_wo_update", "mean_w_update")
MAX_BATCH = 32  # patients per bucket batch, as the JAX test stage
TRAIN_MAX_BATCH = 128  # patients per train bucket, as the JAX train stage


def stage_metrics(cfg: ExperimentConfig) -> MetricsWriter:
    """The run's metrics writer (log/metrics.jsonl); no-op without a log dir."""
    path = (
        os.path.join(cfg.exp_log_dir, "metrics.jsonl")
        if cfg.exp_log_dir
        else None
    )
    run_id = os.path.basename(cfg.exp_top_dir.rstrip("/")) or "run"
    return MetricsWriter(path, run_id=run_id)


def obs_output_order(t: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Flattening order for test outputs: unique timestamps ascending, stable
    original order within a timestamp (main_one_test.cpp:269-443)."""
    valid = np.nonzero(np.asarray(mask) > 0)[0]
    return valid[np.argsort(np.asarray(t)[valid], kind="stable")]


def batch_data(b: PaddedBatch, device: torch.device) -> PatientData:
    return PatientData(
        t=torch.as_tensor(b.t, device=device),
        y=torch.as_tensor(b.y, device=device),
        meta=torch.as_tensor(b.meta, device=device),
        mask=torch.as_tensor(b.mask, device=device),
    )


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def train_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    n_restarts: Optional[int] = None,
    write: bool = True,
    max_batch: int = TRAIN_MAX_BATCH,
    ckpt_dir: Optional[str] = None,
    large_threshold: Optional[int] = None,
    device: torch.device | str = "cuda",
) -> Dict[str, dict]:
    """Train every patient; returns {pan: result dict} and optionally writes
    the reference train artifacts (train_hyp_*, train_init_hyp_*,
    train_var_hyp_*, train_num_*, train_flag_*).

    The restart set is shared by all patients, as in the reference, where
    every per-patient process seeds `srand(random_seed)` identically
    (c_experiment.cpp:418-441). Each bucket of patients of similar length
    trains as one batch (`train_one_patient`), capped by `max_batch` and by
    the train budget of utils/hbm.py; one `train` record per bucket goes to
    log/metrics.jsonl.

    Not ported yet, and refused: patients above the large-patient
    threshold (the row-blocked objective, ROADMAP A7) and per-bucket
    checkpoints (`ckpt_dir`; utils/checkpoints.py, ROADMAP A4)."""
    if ckpt_dir is not None:
        raise NotImplementedError(
            "train_cohort(ckpt_dir=...): per-bucket checkpoints "
            "(medgp_tpu/utils/checkpoints.py) are not ported yet (ROADMAP A4)"
        )
    thr = cfg.large_patient_threshold if large_threshold is None else large_threshold
    large = [r.pan for r in records if r.n_obs > thr]
    if large:
        raise NotImplementedError(
            f"patients {large[:5]} have more than {thr} observations: the "
            "row-blocked large-patient path (medgp_tpu/infer/large_train.py) "
            "is not ported yet (ROADMAP A7)"
        )
    device = torch.device(device)
    spec = cfg.spec()
    S = n_restarts or cfg.random_init_num
    inits = random_inits(cfg.random_seed, spec, cfg.bounds(), S).to(device)
    metrics = stage_metrics(cfg)
    out: Dict[str, dict] = {}
    if not records:
        return out
    n_top = bucket_edges([r.n_obs for r in records])[-1]
    batches = pack_patients(
        records, max_batch=min(max_batch, train_batch_cap(n_top, device)),
        device=device,
    )
    for bidx, b in enumerate(batches):
        t0 = time.perf_counter()
        res = train_one_patient(
            spec, batch_data(b, device), inits,
            prior_mode=cfg.prior_index, eta=cfg.eta, beta_lam=cfg.beta_lam,
            top_iters=cfg.top_iteration_num,
            sub_opt_iter=cfg.iteration_num_per_update,
        )
        theta = res.theta.double().cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        init_theta = res.init_theta.double().cpu().numpy()
        flags = res.flag.cpu().numpy()
        nobs = res.n_obs.cpu().numpy()
        losses = res.loss.double().cpu().numpy()
        evals = int(res.n_evals.sum())
        var_flat = (
            res.var_state.flatten().double().cpu().numpy()
            if cfg.prior_index == 2 else None
        )
        log.info(
            "trained bucket n_max=%d B=%d on %s in %.2fs (%.2f patients/s, "
            "%d objective+gradient evaluations)",
            b.n_max, len(b), device, dt, len(b) / dt, evals,
        )
        metrics.write(
            "train", bucket=bidx, n_max=b.n_max, batch=len(b), devices=1,
            device=str(device), seconds=dt, patients_per_sec=len(b) / dt,
            evaluations=evals, evaluations_per_sec=evals / dt,
            trained=int(flags.sum()),
        )
        for i, pan in enumerate(b.pans):
            out[pan] = dict(
                theta=theta[i], init_theta=init_theta[i], flag=bool(flags[i]),
                loss=float(losses[i]), n_obs=int(nobs[i]),
                var_state=None if var_flat is None else var_flat[i],
            )
            if write:
                formats.write_train_result(
                    cfg.exp_train_dir, pan, theta[i], init_theta[i],
                    None if var_flat is None else var_flat[i],
                    bool(flags[i]), int(nobs[i]),
                )
    return out


# --------------------------------------------------------------------------
# testing
# --------------------------------------------------------------------------

def _test_prior(spec: KernelSpec, mode_theta: np.ndarray, device) -> PriorSpec:
    """Clamp the A-elements that are exactly zero in the mode kernel
    (c_prior.cpp:118-140 `init_test_prior`; LMC-SM only)."""
    prior = empty_prior(spec.n_hyp, device=device)
    if isinstance(spec, LMCSMSpec):
        nl = spec.n_lik
        a = np.asarray(mode_theta)[nl : nl + spec.Q * spec.D * spec.R]
        prior = clamp_a_elements(prior, spec, torch.as_tensor(a == 0.0, device=device))
    return prior


def impute_bucket(
    spec: KernelSpec,
    theta: torch.Tensor,
    b: PaddedBatch,
    device: torch.device,
    update: bool = False,
    prior: Optional[PriorSpec] = None,
    learn_rate: float = 1e-5,
    momentum: float = 0.9,
) -> OnlineResult:
    """`online_impute` of one padded bucket, with its unique timestamps
    padded to the bucket length."""
    ut = np.zeros((len(b), b.n_max), np.float32)
    uv = np.zeros((len(b), b.n_max), bool)
    for i in range(len(b)):
        ut[i], uv[i] = unique_times(b.t[i], b.mask[i], pad_to=b.n_max)
    return online_impute(
        spec, theta, batch_data(b, device),
        torch.as_tensor(ut, device=device), torch.as_tensor(uv, device=device),
        update=update, prior=prior, learn_rate=learn_rate, momentum=momentum,
    )


def test_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    folds: Optional[np.ndarray] = None,
    kernclust_alg: str = "gmm",
    modes=TEST_MODES,
    device: torch.device | str = "cuda",
) -> Dict[str, dict]:
    """Online imputation for every patient with its fold's mode kernel.

    `folds[i]` selects kernel/fold{f}/ for records[i]; None uses fold -1
    ("all"). `mean_w_update` updates each patient's hypers online under
    the test prior (A-elements that are zero in the mode kernel stay
    clamped) with the experiment's learning rate and momentum.

    etime keeps the JAX package's meaning: the bucket's wall time,
    transfers and synchronisation included, divided by its predictions.
    """
    unknown = [m for m in modes if m not in TEST_MODES]
    if unknown:
        raise ValueError(f"unknown test modes {unknown}; expected {TEST_MODES}")
    device = torch.device(device)
    feature_list = cfg.feature_list
    out: Dict[str, dict] = {}
    metrics = stage_metrics(cfg)
    folds = (
        np.full(len(records), -1, int) if folds is None else np.asarray(folds)
    )
    for fold in np.unique(folds):
        mode_theta, newQ = formats.read_mode_kernel(
            cfg.exp_kernel_dir, int(fold), kernclust_alg
        )
        spec = cfg.test_spec(newQ)
        theta = theta_from_numpy(spec, mode_theta, device)
        prior = _test_prior(spec, mode_theta, device)

        sel = [r for r, f in zip(records, folds) if f == fold]
        for rec in sel:
            if rec.n_obs == 0:
                out[rec.pan] = {m: dict(flag=False) for m in modes}
                for m in modes:
                    formats.write_test_result(
                        cfg.exp_test_dir, m, rec.pan,
                        np.zeros(0, int), np.zeros(0), np.zeros(0),
                        np.zeros(0, int), np.zeros(0), flag=False,
                    )

        batches = pack_patients(
            [r for r in sel if r.n_obs > 0], max_batch=MAX_BATCH,
            device=device,
        )
        for b in batches:
            total_obs = int(np.sum(b.mask))
            res_by_mode, etime_by_mode = {}, {}
            for m in modes:
                t0 = time.perf_counter()
                res = impute_bucket(
                    spec, theta, b, device, update=m == "mean_w_update",
                    prior=prior, learn_rate=cfg.online_learn_rate,
                    momentum=cfg.online_momentum,
                )
                res_by_mode[m] = OnlineResult(
                    *(x.cpu() for x in res)  # waits for the device
                )
                dt = time.perf_counter() - t0
                etime_by_mode[m] = dt / max(total_obs, 1)
                log.info(
                    "tested bucket fold=%s mode=%s n_max=%d B=%d on %s in %.2fs",
                    fold, m, b.n_max, len(b), device, dt,
                )
                metrics.write(
                    "test", fold=int(fold), mode=m, n_max=b.n_max,
                    batch=len(b), devices=1, device=str(device), seconds=dt,
                    predictions=total_obs,
                    sec_per_prediction=etime_by_mode[m],
                )

            for i, pan in enumerate(b.pans):
                order = obs_output_order(b.t[i], b.mask[i])
                feat = np.asarray(
                    [feature_list[j] for j in b.meta[i][order]], int
                )
                entry = {}
                for m, res in res_by_mode.items():
                    pred = res.pred[i].numpy().astype(np.float64)[order]
                    err = res.error[i].numpy().astype(np.float64)[order]
                    ci = res.ci[i].numpy()[order]
                    pvar = res.var[i].numpy().astype(np.float64)[order]
                    etime = np.full(len(order), etime_by_mode[m])
                    entry[m] = dict(
                        flag=True, pred=pred, error=err, ci=ci, feature=feat,
                        etime=etime, var=pvar,
                    )
                    formats.write_test_result(
                        cfg.exp_test_dir, m, pan,
                        feat, pred, err, ci, etime, flag=True, var=pvar,
                    )
                out[pan] = entry
    return out
