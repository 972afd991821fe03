"""Cohort evaluation: per-feature patient-wise MAE, 95% CI coverage and
predictive NLL.

Host copy (numpy) of ``medgp_tpu/evaluation/evals.py``, trimmed to what
the CLI `eval` and `run` use; it writes the same files and returns the same
summary. For each configured feature the stored predictions are
de-normalized with the cohort stats and aligned 1:1 with the raw feature
file's values (medgpc/evaluation/evals.py:7-61); per-patient vectors go to
test_{mode}_feature{f}_{mae,ci_ratio,nll}.bin, failed patients left out.
"""

from __future__ import annotations

import os
from typing import Dict, Sequence

import numpy as np

from medgp_tpu_torch.data import formats


def compute_mae(error: np.ndarray) -> float:
    return float(np.nanmean(np.abs(error)))


def compute_coverage(ci_flags: np.ndarray) -> float:
    return 100.0 * float(np.nanmean(ci_flags))


def compute_nll(error: np.ndarray, var: np.ndarray) -> float:
    """Mean Gaussian predictive negative log-likelihood per observation;
    `error` and `var` on the raw scale."""
    var = np.maximum(np.asarray(var, np.float64), 1e-12)
    return float(np.nanmean(
        0.5 * np.asarray(error, np.float64) ** 2 / var
        + 0.5 * np.log(2.0 * np.pi * var)
    ))


def eval_cohort(
    data_dir: str,
    test_dir: str,
    test_mode: str,
    feature_index: Sequence[int],
    pans: Sequence[str],
    metrics=None,
) -> Dict[int, Dict[str, np.ndarray]]:
    """{feature_idx: {"mae": (P_valid,), "ci_ratio": (P_valid,)[, "nll"]}};
    one `eval` metrics record per feature when `metrics` is given."""
    if not any(
        os.path.exists(formats.test_paths(test_dir, test_mode, str(p))["flag"])
        for p in pans
    ):
        raise FileNotFoundError(
            f"no test outputs found for mode '{test_mode}' in {test_dir} - "
            "run the test stage first or check --test-mode "
            "(mean_wo_update | mean_w_update)"
        )
    results = {}  # each patient's outputs, read once for every feature
    for pan in pans:
        try:
            flag, res = formats.read_test_result(test_dir, test_mode, str(pan))
        except OSError:
            continue
        if flag and res is not None:
            results[pan] = res
    out: Dict[int, Dict[str, np.ndarray]] = {}
    for fidx in feature_index:
        mean, std = formats.read_feature_stat(
            os.path.join(data_dir, f"feature{fidx}_stat.bin")
        )
        mae = np.full(len(pans), -1.0)
        cov = np.full(len(pans), -1.0)
        nll = np.full(len(pans), np.nan)
        for i, pan in enumerate(pans):
            res = results.get(pan)
            if res is None:
                continue
            sel = np.nonzero(res["feature"] == fidx)[0]
            pred = res["pred"][sel] * std + mean
            _, raw_v = formats.read_feature_txt(
                os.path.join(data_dir, str(pan), f"feature{fidx}.txt")
            )
            if len(pred) != len(raw_v):
                raise ValueError(
                    f"prediction/raw mismatch for {pan} feature{fidx}: "
                    f"{len(pred)} vs {len(raw_v)}"
                )
            err = raw_v - pred
            mae[i] = compute_mae(err)
            cov[i] = compute_coverage(res["ci"][sel])
            if res.get("var") is not None:
                nll[i] = compute_nll(err, res["var"][sel] * std**2)

        valid = mae >= 0.0
        res_f = dict(mae=mae[valid], ci_ratio=cov[valid])
        if np.isfinite(nll[valid]).any():
            res_f["nll"] = nll[valid]
        out[fidx] = res_f
        if metrics is not None:
            extra = {"nll": res_f["nll"]} if "nll" in res_f else {}
            metrics.write(
                "eval", mode=test_mode, feature=int(fidx),
                valid_patients=int(valid.sum()), mae=res_f["mae"],
                ci_ratio=res_f["ci_ratio"], **extra,
            )
        for name, vec in res_f.items():
            formats.write_double_bin(
                os.path.join(test_dir, f"test_{test_mode}_feature{fidx}_{name}.bin"),
                vec,
            )
    return out


def summarize(results: Dict[int, Dict[str, np.ndarray]]) -> Dict[str, float]:
    """Cohort scalars: the mean of per-patient MAE / coverage / NLL by
    feature, averaged over features."""
    maes, covs, nlls = [], [], []
    for r in results.values():
        if len(r["mae"]):
            maes.append(np.mean(r["mae"]))
            covs.append(np.mean(r["ci_ratio"]))
            if "nll" in r:
                nlls.append(np.nanmean(r["nll"]))
    out = dict(
        mae=float(np.mean(maes)) if maes else float("nan"),
        ci_ratio=float(np.mean(covs)) if covs else float("nan"),
    )
    if nlls:
        out["nll"] = float(np.mean(nlls))
    return out


def mae_mean_se(test_dir: str, test_mode: str, feature_index: Sequence[int]):
    """(mean, SE, N) of the per-(patient, feature) MAE values that
    `eval_cohort` wrote for `test_mode`; SE = std (ddof 1) / sqrt(N)."""
    v = np.concatenate([
        formats.read_double_bin(
            os.path.join(test_dir, f"test_{test_mode}_feature{f}_mae.bin")
        )
        for f in feature_index
    ])
    return float(v.mean()), float(v.std(ddof=1) / np.sqrt(len(v))), len(v)
