"""Top-level kernel-clustering pipeline for one CV fold.

Counterpart of ``medgp_tpu/cluster/pipeline.py``; it mirrors the reference
flow (medgpc/clustering/kernclust.py:11-58):
  1. select training-fold patients (cv_assign != fold; fold == -1 keeps all);
  2. load successfully trained kernels (flag-filtered);
  3. extract per-component clustering features;
  4. cluster (GMM + BIC, or a single cluster for algorithm None);
  5. estimate the population mode kernel and write the fold's
     {alg}_mode_param.bin + {alg}_mode_mixture_num.txt.

The GMM and the KDEs run on `device` (the CUDA card unless the caller
names another); the rest is host numpy. The stage also runs from arrays in
memory, the fused `run`'s train -> kernclust handoff.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from medgp_tpu_torch.cluster.features import extract_kernel_features
from medgp_tpu_torch.cluster.gmm import run_clustering_top
from medgp_tpu_torch.cluster.mode import (
    mode_kernel_lmcsm, mode_kernel_se, mode_kernel_sm,
)
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.models.params import LMCSMSpec, SESpec


def cluster_kernels(
    spec,
    pans: np.ndarray,
    hyps: np.ndarray,
    algorithm: str = "gmm",
    seed: int = 0,
    device="cuda",
    noise_mode: np.ndarray | None = None,
):
    """In-memory clustering + mode estimation: (mode_theta, newQ), with at
    most spec.Q clusters. `hyps` is (P, H) flat theta of successfully
    trained patients; `noise_mode` optionally carries the (D,) log
    noise-mode block computed over a mesh (LMC-SM only)."""
    pans = np.asarray(pans)
    if isinstance(spec, SESpec):
        return mode_kernel_se(pans, hyps, device=device), 1
    comp_pan, comp_qidx, comp_feat = extract_kernel_features(spec, pans, hyps)
    cluster_num, cluster_assign = run_clustering_top(
        algorithm, comp_feat, max_cluster_num=spec.Q, seed=seed,
        device=device,
    )
    if isinstance(spec, LMCSMSpec):
        mode_theta = mode_kernel_lmcsm(
            spec, pans, hyps, comp_pan, comp_qidx, cluster_num, cluster_assign,
            device=device, noise_mode=noise_mode,
        )
    else:
        mode_theta = mode_kernel_sm(
            spec, pans, hyps, comp_pan, comp_qidx, cluster_num, cluster_assign,
            device=device,
        )
    return mode_theta, int(cluster_num)


def _cluster_fold(spec, kernel_dir, pans, hyps, fold, algorithm, seed,
                  metrics, device, noise_mode=None):
    if len(pans) == 0:
        raise RuntimeError(f"no successfully trained patients for fold {fold}")
    mode_theta, newQ = cluster_kernels(
        spec, pans, hyps, algorithm=algorithm, seed=seed, device=device,
        noise_mode=noise_mode,
    )
    formats.write_mode_kernel(kernel_dir, fold, algorithm, mode_theta, newQ)
    if metrics is not None:
        metrics.write(
            "kernclust", fold=int(fold), algorithm=algorithm,
            patients=len(pans), mixture_num=int(newQ),
        )
    return mode_theta, newQ


def kernel_clustering_fold_in_memory(
    spec,
    kernel_dir: str,
    pans: Sequence[str],
    hyps: np.ndarray,
    cv_assign: np.ndarray,
    all_pans: Sequence[str],
    fold: int,
    algorithm: str = "gmm",
    seed: int = 0,
    metrics=None,
    device="cuda",
    noise_mode: np.ndarray | None = None,
):
    """Fold clustering fed from in-memory training results. `pans`/`hyps`
    are the successfully trained patients (any order); `cv_assign` is
    indexed by position in `all_pans`; `noise_mode` is the fold's (D,) log
    noise-mode block from the mesh, if any (medgp_tpu/cluster/pipeline.py:
    67-104). The mode-kernel files are written as the file-based stage
    writes them."""
    pans = np.asarray([str(p) for p in pans])
    fold_of = {str(p): int(f) for p, f in zip(all_pans, np.asarray(cv_assign))}
    keep = np.asarray([fold == -1 or fold_of[p] != fold for p in pans], bool)
    return _cluster_fold(
        spec, kernel_dir, pans[keep], np.asarray(hyps)[keep], fold, algorithm,
        seed, metrics, device, noise_mode,
    )


def kernel_clustering_fold(
    spec,
    train_dir: str,
    kernel_dir: str,
    all_pans: Sequence[str],
    cv_assign: np.ndarray,
    fold: int,
    algorithm: str = "gmm",
    seed: int = 0,
    metrics=None,
    device="cuda",
):
    """File-based fold clustering (the reference CLI's unit of work)."""
    all_pans = np.asarray([str(p) for p in all_pans])
    sel = all_pans if fold == -1 else all_pans[np.asarray(cv_assign) != fold]
    pans, hyps = formats.read_train_kernels(train_dir, sel)
    return _cluster_fold(
        spec, kernel_dir, pans, hyps, fold, algorithm, seed, metrics, device
    )
