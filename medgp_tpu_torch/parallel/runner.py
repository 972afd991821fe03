"""Cohort-level test stage over padded buckets.

Counterpart of the test half of ``medgp_tpu/parallel/runner.py``
(`test_cohort`, `obs_output_order`, `stage_metrics`). Each padded bucket of
patients runs as one batched `online_impute` on one device; the TPU-only
parts (pow-2 batch padding to bound recompiles, the device mesh, the
explicit compile step) have no counterpart here.
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
from medgp_tpu_torch.data.cohort import PaddedBatch, PatientRecord, pack_patients
from medgp_tpu_torch.infer.online import OnlineResult, online_impute, unique_times
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import KernelSpec, theta_from_numpy
from medgp_tpu_torch.utils.metrics import MetricsWriter

log = logging.getLogger("medgp_tpu_torch")

TEST_MODES = ("mean_wo_update",)
MAX_BATCH = 32  # patients per bucket batch, as the JAX test stage


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


def impute_bucket(
    spec: KernelSpec,
    theta: torch.Tensor,
    b: PaddedBatch,
    device: torch.device,
) -> OnlineResult:
    """`online_impute` of one padded bucket, with its unique timestamps
    padded to the bucket length."""
    ut = np.zeros((len(b), b.n_max), np.float32)
    uv = np.zeros((len(b), b.n_max), bool)
    for i in range(len(b)):
        ut[i], uv[i] = unique_times(b.t[i], b.mask[i], pad_to=b.n_max)
    data = PatientData(
        t=torch.as_tensor(b.t, device=device),
        y=torch.as_tensor(b.y, device=device),
        meta=torch.as_tensor(b.meta, device=device),
        mask=torch.as_tensor(b.mask, device=device),
    )
    return online_impute(
        spec, theta, data,
        torch.as_tensor(ut, device=device), torch.as_tensor(uv, device=device),
        update=False,
    )


def test_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    folds: Optional[np.ndarray] = None,
    kernclust_alg: str = "gmm",
    modes=TEST_MODES,
    device: torch.device | str = "cpu",
) -> Dict[str, dict]:
    """Online imputation for every patient with its fold's mode kernel.

    `folds[i]` selects kernel/fold{f}/ for records[i]; None uses fold -1
    ("all"). Only the `mean_wo_update` mode is ported; asking for another
    raises NotImplementedError.

    etime keeps the JAX package's meaning: the bucket's wall time,
    transfers and synchronisation included, divided by its predictions.
    """
    unknown = [m for m in modes if m not in TEST_MODES]
    if unknown:
        raise NotImplementedError(
            f"test modes {unknown} are not ported: mean_w_update runs online "
            "hyperparameter updates, which need the objective gradient "
            "(the training slice)"
        )
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
                res = impute_bucket(spec, theta, b, device)
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
