"""Cohort-level train and test stages over padded buckets.

Counterpart of ``medgp_tpu/parallel/runner.py`` (`train_cohort`,
`test_cohort`, `hmc_cohort`, `obs_output_order`, `stage_metrics`,
`_test_prior`). Each padded bucket of patients runs as one batched
`train_one_patient`, `online_impute` or sampler call. When the
`torch.distributed` world has more than one rank (or the caller passes
use_mesh=True), every bucket is padded to a multiple of the world with
all-masked dummies and sharded over the ranks (parallel/mesh.py): each
rank runs its slice on its device, the results are all-gathered to every
rank, rank 0 alone writes the files, and every rank waits for the writes
before the function returns. LMC-SM patients above the large-patient
threshold train one at a time by row blocks (`infer/large_train.py`),
row-sharded over the same ranks. The TPU-only parts (pow-2 batch padding
to bound recompiles, the explicit compile step) have no counterpart here.
"""

from __future__ import annotations

import hashlib
import logging
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from medgp_tpu_torch.config.experiment import ExperimentConfig
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import (
    PaddedBatch, PatientRecord, bucket_edges, pack_patients,
)
from medgp_tpu_torch.data.inits import random_inits
from medgp_tpu_torch.infer.diagnostics import (
    invariant_posterior_mean, summarize_diagnostics,
)
from medgp_tpu_torch.infer.hmc import hmc_patient
from medgp_tpu_torch.infer.streams import PAD_KEY, patient_streams
from medgp_tpu_torch.infer.large_train import train_one_large_patient
from medgp_tpu_torch.infer.map_train import train_one_patient
from medgp_tpu_torch.infer.nuts import nuts_patient
from medgp_tpu_torch.infer.online import OnlineResult, online_impute, unique_times
from medgp_tpu_torch.infer.vi import vi_patient
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, theta_from_numpy
from medgp_tpu_torch.models.priors import (
    PriorSpec, clamp_a_elements, empty_prior, hier_gamma_prior,
)
from medgp_tpu_torch.parallel.mesh import (
    CohortMesh, barrier, cohort_mesh, min_free_bytes, pad_batch_to, round_up,
    sharded_sampler_step, sharded_test_step, sharded_train_step, take_rows,
)
from medgp_tpu_torch.utils.checkpoints import CohortCheckpointer
from medgp_tpu_torch.utils.hbm import train_batch_cap
from medgp_tpu_torch.utils.metrics import MetricsWriter, since, snapshot, span

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


def mesh_or_none(use_mesh: Optional[bool], device: torch.device) -> Optional[CohortMesh]:
    """The mesh policy (medgp_tpu/parallel/runner.py:64-71): shard over the
    `torch.distributed` world when it has more than one rank
    (use_mesh=None), or as the caller forces; this rank runs on `device`."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    on = use_mesh if use_mesh is not None else world > 1
    return cohort_mesh(device) if on else None


def _world(mesh: Optional[CohortMesh]) -> int:
    return 1 if mesh is None else mesh.world


def _plan_bytes(mesh: Optional[CohortMesh]) -> Optional[int]:
    """The free bytes the bucket caps plan with: over a mesh the least of
    any rank's (`min_free_bytes`), so every rank forms the same buckets;
    without one None, and each cap reads the device when it is asked."""
    return None if mesh is None else min_free_bytes(mesh)


def _writes(mesh: Optional[CohortMesh]) -> bool:
    """Rank 0 alone writes the reference artifacts."""
    return mesh is None or mesh.rank == 0


# --------------------------------------------------------------------------
# training
# --------------------------------------------------------------------------

def bucket_key(pans: Sequence[str]) -> np.ndarray:
    """A bucket's checkpoint key: the first 8 bytes of the sha256 of its
    patient ids joined by "|", read as one int64 (the JAX package's key)."""
    h = hashlib.sha256("|".join(pans).encode()).digest()[:8]
    return np.frombuffer(h, np.int64)


def _train_bucket(cfg, spec, b: PaddedBatch, bidx, inits, device, metrics, mesh):
    """Train one bucket (over the mesh, padded to a multiple of the world
    and sharded); returns host (theta, init_theta, flags, losses, n_obs,
    var_flat or None) of its patients and writes its `train` metrics
    record, which carries what the table of spans and counters
    (utils/metrics.py) gained in the bucket."""
    kw = dict(prior_mode=cfg.prior_index, eta=cfg.eta, beta_lam=cfg.beta_lam,
              top_iters=cfg.top_iteration_num, sub_opt_iter=cfg.iteration_num_per_update)
    B = len(b)
    before = snapshot()
    with span("medgp.train.bucket"):
        t0 = time.perf_counter()
        if mesh is None:
            res = train_one_patient(spec, batch_data(b, device), inits, **kw)
        else:
            step = sharded_train_step(spec, mesh, inits, **kw)
            res = take_rows(step(pad_batch_to(batch_data(b, device), round_up(B, mesh.world))), B)
        with span("medgp.train.fetch"):
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
        "trained bucket n_max=%d B=%d on %d device(s) (%s) in %.2fs (%.2f patients/s, "
        "%d objective+gradient evaluations)",
        b.n_max, len(b), _world(mesh), device, dt, len(b) / dt, evals,
    )
    metrics.write(
        "train", bucket=bidx, n_max=b.n_max, batch=len(b), devices=_world(mesh),
        device=str(device), seconds=dt, patients_per_sec=len(b) / dt,
        evaluations=evals, evaluations_per_sec=evals / dt, nlml=losses,
        trained=int(flags.sum()), **since(before),
    )
    return theta, init_theta, flags, losses, nobs, var_flat


def train_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    n_restarts: Optional[int] = None,
    write: bool = True,
    max_batch: int = TRAIN_MAX_BATCH,
    ckpt_dir: Optional[str] = None,
    large_threshold: Optional[int] = None,
    device: torch.device | str = "cuda",
    use_mesh: Optional[bool] = None,
) -> Dict[str, dict]:
    """Train every patient; returns {pan: result dict} and optionally writes
    the reference train artifacts (train_hyp_*, train_init_hyp_*,
    train_var_hyp_*, train_num_*, train_flag_*).

    Over a mesh (`mesh_or_none(use_mesh)`) each bucket is padded to a
    multiple of the world with all-masked dummies and sharded over the
    ranks (`max_batch` rounded up to a multiple of it), each large patient
    is row-sharded, and every record carries devices=W
    (medgp_tpu/parallel/runner.py:186-240, 350-380). Unlike the JAX
    runner, the buckets are one rank's: no remainder is promoted into a
    longer bucket, where its padded length, and so its float32 bits,
    would change.

    The restart set is shared by all patients, as in the reference, where
    every per-patient process seeds `srand(random_seed)` identically
    (c_experiment.cpp:418-441). Each bucket of patients of similar length
    trains as one batch (`train_one_patient`), capped by `max_batch` and by
    the train budget of utils/hbm.py; one `train` record per bucket goes to
    log/metrics.jsonl.

    With `ckpt_dir`, each finished bucket is saved (utils/checkpoints.py)
    under a key made from its patients; a re-run restores every bucket
    whose key matches and trains the rest.

    LMC-SM patients above the large-patient threshold (`large_threshold`,
    default cfg.large_patient_threshold) train after the buckets, one at a
    time, by row blocks (`train_one_large_patient`, from the first
    cfg.large_patient_restarts restarts), each with a `train_large` record
    (pan, n_obs, devices, blocks, block_rows, seconds, nlml, trained); checkpoints stay per
    bucket. SE and SM patients above it train in ordinary buckets, as in
    the JAX package (medgp_tpu/parallel/runner.py:189-208, 355-386)."""
    spec = cfg.spec()
    thr = cfg.large_patient_threshold if large_threshold is None else large_threshold
    large = []
    if isinstance(spec, LMCSMSpec):
        large = [r for r in records if r.n_obs > thr]
        records = [r for r in records if r.n_obs <= thr]
    device = torch.device(device)
    mesh = mesh_or_none(use_mesh, device)
    write = write and _writes(mesh)
    S = n_restarts or cfg.random_init_num
    inits = random_inits(cfg.random_seed, spec, cfg.bounds(), S).to(device)
    metrics = stage_metrics(cfg)
    out: Dict[str, dict] = {}
    if records:
        _train_buckets(cfg, spec, records, inits, max_batch, ckpt_dir, device,
                       metrics, write, out, mesh)
    for rec in large:
        t0 = time.perf_counter()
        res = train_one_large_patient(
            spec, rec.t, rec.y, rec.meta, inits[:cfg.large_patient_restarts],
            prior_mode=cfg.prior_index, eta=cfg.eta, beta_lam=cfg.beta_lam,
            top_iters=cfg.top_iteration_num,
            sub_opt_iter=cfg.iteration_num_per_update, device=device, mesh=mesh,
        )
        dt = time.perf_counter() - t0
        log.info(
            "trained large patient %s (n=%d, by row blocks over %d device(s)) in "
            "%.1fs: flag=%s loss=%.3f", rec.pan, rec.n_obs, _world(mesh), dt,
            res["flag"], res["loss"],
        )
        metrics.write(
            "train_large", pan=rec.pan, n_obs=rec.n_obs, devices=_world(mesh),
            blocks=res["blocks"], block_rows=res["block_rows"],
            seconds=dt, nlml=res["loss"], trained=int(res["flag"]),
        )
        out[rec.pan] = res
        if write:
            formats.write_train_result(
                cfg.exp_train_dir, rec.pan, res["theta"], res["init_theta"],
                res["var_state"], res["flag"], res["n_obs"],
            )
    barrier(mesh)
    return out


def _train_buckets(cfg, spec, records, inits, max_batch, ckpt_dir, device,
                   metrics, write, out, mesh):
    """The bucketed half of `train_cohort`: fills `out` and writes the
    train files of every bucket, trained or restored from `ckpt_dir` (every
    rank reads the checkpoint, rank 0 writes it)."""
    W = _world(mesh)
    free = _plan_bytes(mesh)
    n_top = bucket_edges([r.n_obs for r in records])[-1]
    # one rank's buckets (no remainder promoted): each patient keeps its
    # padded length, so a sharded run repeats one rank's bits
    batches = pack_patients(
        records, max_batch=min(round_up(max_batch, W), W * train_batch_cap(n_top, device, free)),
        device=device, free_bytes=free,
    )
    ckpt = CohortCheckpointer(ckpt_dir) if ckpt_dir else None
    for bidx, b in enumerate(batches):
        key = bucket_key(b.pans)
        saved = ckpt.load_bucket(bidx) if ckpt is not None else None
        if saved is not None and np.array_equal(saved.get("key"), key):
            log.info(
                "resumed bucket %d (n_max=%d B=%d) from checkpoint",
                bidx, b.n_max, len(b),
            )
            theta, init_theta = saved["theta"], saved["init_theta"]
            flags, losses = saved["flag"].astype(bool), saved["loss"]
            nobs, var_flat = saved["n_obs"], saved.get("var_flat")
        else:
            theta, init_theta, flags, losses, nobs, var_flat = _train_bucket(
                cfg, spec, b, bidx, inits, device, metrics, mesh
            )
            if ckpt is not None and _writes(mesh):
                ckpt.save_bucket(bidx, dict(
                    key=key, theta=theta, init_theta=init_theta,
                    flag=flags.astype(np.int8), loss=losses, n_obs=nobs,
                    var_flat=var_flat,
                ))
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


# --------------------------------------------------------------------------
# HMC/NUTS/VI posterior sampling
# --------------------------------------------------------------------------

SAMPLERS = ("hmc", "nuts", "vi")


def hmc_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    num_chains: int = 4,
    num_warmup: int = 300,
    num_samples: int = 300,
    num_leapfrog: int = 16,
    init_step_size: float = 0.005,
    write: bool = True,
    seed: int = 0,
    sampler: str = "hmc",
    max_depth: int = 6,
    max_batch: int = 32,
    large_threshold: Optional[int] = None,
    device: torch.device | str = "cuda",
    use_mesh: Optional[bool] = None,
) -> Dict[str, dict]:
    """Posterior inference for every trained patient, started at its MAP
    hypers (train_hyp_*.bin) (medgp_tpu/parallel/runner.py:394-635), on
    one device or sharded over the ranks of the mesh as `train_cohort`
    shards (runner.py:701-770 there). Every (patient, chain) row draws from
    its own stream (`infer/streams.py`), keyed by `seed` and the patient's
    index in `cfg.pans()` (padding rows by PAD_KEY), as the JAX runner
    gives every row its own key: a patient's draws depend neither on its
    rank nor on its batch mates. No remainder is promoted into a longer
    bucket (the JAX runner promotes): as in `train_cohort` and
    `test_cohort`, each patient keeps its padded length at any world, and
    a bucket, capped by the W ranks' memory together, is padded with at
    most W - 1 dummies.
    `sampler` is "hmc" (jittered trajectories, `num_leapfrog`),
    "nuts" (adaptive trajectories, `max_depth`) or "vi" (mean-field ADVI,
    one chain: `num_warmup` optimization steps, `num_samples` draws from
    the fitted q). The hier-gamma prior applies to LMC-SM experiments with
    prior_index 2, else none.

    Each bucket runs all chains of all its patients as one batch of rows,
    its size capped by `max_batch` and by the gram budget divided by two
    grams per chain (`pack_patients(footprint_mult=...)`). One `{sampler}`
    record per bucket goes to log/metrics.jsonl, and one `{sampler}_diag`
    record (min bulk ESS, max split-R-hat) per HMC or NUTS patient.
    Patients above the large-patient threshold are skipped (a
    `sampler_skip` record; out[pan] = {"flag": False, "reason":
    "large_patient"}) and keep their MAP hypers.

    Writes train_{hmc|vi}_mean_{pan}.bin (the posterior mean: the
    invariant mean of the draws for HMC and NUTS, the variational mean for
    VI) and train_{hmc|vi}_samples_{pan}.npz (chains x draws x H plus the
    diagnostics) next to the train files; returns {pan: dict(samples,
    post_mean, **diagnostics)}."""
    if sampler not in SAMPLERS:
        raise ValueError(f"unknown sampler {sampler!r} (use 'hmc', 'nuts' or 'vi')")
    device = torch.device(device)
    spec = cfg.spec()
    prior = (
        hier_gamma_prior(spec, beta_lam=cfg.beta_lam, device=device)
        if cfg.prior_index == 2 and isinstance(spec, LMCSMSpec)
        else None
    )
    pans, hyps = formats.read_train_kernels(cfg.exp_train_dir, [r.pan for r in records])
    by_pan = dict(zip(pans, hyps))
    mesh = mesh_or_none(use_mesh, device)
    write = write and _writes(mesh)
    W = _world(mesh)
    cohort_index = {p: i for i, p in enumerate(cfg.pans())}
    metrics = stage_metrics(cfg)

    thr = cfg.large_patient_threshold if large_threshold is None else large_threshold
    skipped = [r.pan for r in records if r.n_obs > thr]
    if skipped:
        log.warning(
            "%s: skipping %d patient(s) above large-patient threshold "
            "n_obs>%d (%s): bucketed posterior sampling would build an "
            "(n,n) gram per chain; these patients keep their MAP hypers",
            sampler, len(skipped), thr, ", ".join(skipped[:5]),
        )
        metrics.write(
            "sampler_skip", sampler=sampler, reason="large_patient",
            threshold=thr, pans=",".join(skipped), n_skipped=len(skipped),
        )
    out: Dict[str, dict] = {
        pan: {"flag": False, "reason": "large_patient"} for pan in skipped
    }
    trained = [r for r in records if r.pan in by_pan and 0 < r.n_obs <= thr]
    chains = 1 if sampler == "vi" else num_chains
    # a bucket's rows are split over the ranks: its cap is the W ranks'
    # memory together, each planned from the least free of any rank
    batches = pack_patients(
        trained, max_batch=round_up(max_batch, W), device=device,
        footprint_mult=2 * chains, free_bytes=None if mesh is None else W * _plan_bytes(mesh),
    )

    def run_one(theta0, t, y, meta, mask, streams):
        data = PatientData(t, y, meta, mask)
        if sampler == "vi":
            return vi_patient(
                spec, data, theta0, streams, prior=prior,
                num_steps=num_warmup, num_samples=num_samples,
            )
        if sampler == "nuts":
            return nuts_patient(
                spec, data, theta0, streams, prior=prior, num_chains=num_chains,
                num_warmup=num_warmup, num_samples=num_samples,
                init_step_size=init_step_size, max_depth=max_depth,
            )
        return hmc_patient(
            spec, data, theta0, streams, prior=prior, num_chains=num_chains,
            num_warmup=num_warmup, num_samples=num_samples,
            init_step_size=init_step_size, num_leapfrog=num_leapfrog,
        )

    run_bucket = run_one if mesh is None else sharded_sampler_step(run_one, mesh)
    prefix = "vi" if sampler == "vi" else "hmc"
    for b in batches:
        B = len(b)
        theta0 = torch.as_tensor(
            np.stack([by_pan[p] for p in b.pans]).astype(np.float32), device=device
        )
        data = batch_data(b, device)
        Bp = round_up(B, W)
        if Bp > B:
            data = pad_batch_to(data, Bp)
            theta0 = torch.cat([theta0, theta0.new_zeros((Bp - B, theta0.shape[1]))])
        streams = patient_streams(
            seed, [cohort_index[p] for p in b.pans] + [PAD_KEY] * (Bp - B), device)
        t0 = time.perf_counter()
        res = take_rows(run_bucket(theta0, *data, streams), B)
        samples_all = res.samples.cpu().numpy()  # waits for the device
        dt = time.perf_counter() - t0
        log.info(
            "%s bucket B=%d n_max=%d on %s: %d chains x %d samples/patient in "
            "%.1fs (%.1f samples/s)",
            sampler, B, b.n_max, f"{W} device(s) ({device})", chains, num_samples, dt,
            B * chains * num_samples / dt,
        )
        if sampler == "vi":
            samples_all = samples_all[:, None]  # (B, 1, S, H)
            elbo = res.elbo.cpu().numpy()
            converged = res.converged.cpu().numpy()
            log_std = res.log_std.cpu().numpy()
            diag_scalars = dict(elbo=elbo)
            diags_all = [
                dict(elbo=elbo[i], converged=converged[i], log_std=log_std[i])
                for i in range(B)
            ]
            # the variational mean is the posterior mean, exactly
            means_all = res.mean.cpu().numpy()
        else:
            acc = res.accept_rate.cpu().numpy()
            eps = res.step_size.cpu().numpy()
            divs = res.divergences.cpu().numpy()
            diag_scalars = dict(accept_rate=acc.ravel(), divergences=int(divs.sum()))
            diags_all = []
            for i in range(B):
                # rank-normalized split-R-hat and bulk ESS per hyper block
                # (Vehtari et al. 2021)
                d = dict(accept_rate=acc[i], step_size=eps[i], divergences=divs[i])
                d.update(summarize_diagnostics(samples_all[i], spec))
                diags_all.append(d)
            # the mean in the identified parametrization: the raw
            # coordinate mean is degenerate under A's sign symmetry and
            # cross-chain label switching
            means_all = np.stack(
                [invariant_posterior_mean(spec, samples_all[i]) for i in range(B)]
            ).astype(samples_all.dtype)
        metrics.write(
            sampler, n_max=b.n_max, batch=B, devices=W, device=str(device),
            seconds=dt, samples_per_sec=B * chains * num_samples / dt,
            **diag_scalars,
        )
        if sampler != "vi":
            for pan, d in zip(b.pans, diags_all):
                metrics.write(
                    f"{sampler}_diag", pan=pan,
                    ess_bulk_min=d["ess_bulk_min"], rhat_max=d["rhat_max"],
                )
        for i, pan in enumerate(b.pans):
            out[pan] = dict(samples=samples_all[i], post_mean=means_all[i], **diags_all[i])
            if write:
                formats.write_double_bin(
                    os.path.join(cfg.exp_train_dir, f"train_{prefix}_mean_{pan}.bin"),
                    means_all[i],
                )
                np.savez(
                    os.path.join(cfg.exp_train_dir, f"train_{prefix}_samples_{pan}.npz"),
                    samples=samples_all[i], **diags_all[i],
                )
    barrier(mesh)
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
    mesh: Optional[CohortMesh] = None,
) -> OnlineResult:
    """`online_impute` of one padded bucket, with its unique timestamps
    padded to the bucket length; over a mesh the bucket is padded to a
    multiple of the world and sharded (`sharded_test_step`)."""
    B = len(b)
    Bp = round_up(B, _world(mesh))
    ut = np.zeros((Bp, b.n_max), np.float32)
    uv = np.zeros((Bp, b.n_max), bool)
    for i in range(B):
        ut[i], uv[i] = unique_times(b.t[i], b.mask[i], pad_to=b.n_max)

    def run_one(th, pr, t, y, meta, mask, u_t, u_v):
        return online_impute(
            spec, th, PatientData(t, y, meta, mask), u_t, u_v,
            update=update, prior=pr, learn_rate=learn_rate, momentum=momentum,
        )

    data = pad_batch_to(batch_data(b, device), Bp)
    run = run_one if mesh is None else sharded_test_step(run_one, mesh, n_rep_args=2)
    res = run(theta, prior, *data, torch.as_tensor(ut, device=device),
              torch.as_tensor(uv, device=device))
    return take_rows(res, B)


def test_cohort(
    cfg: ExperimentConfig,
    records: Sequence[PatientRecord],
    folds: Optional[np.ndarray] = None,
    kernclust_alg: str = "gmm",
    modes=TEST_MODES,
    device: torch.device | str = "cuda",
    use_mesh: Optional[bool] = None,
) -> Dict[str, dict]:
    """Online imputation for every patient with its fold's mode kernel;
    returns {pan: {mode: result dict}} and writes the test files.

    `folds[i]` selects kernel/fold{f}/ for records[i]; None uses fold -1
    ("all"). `mean_w_update` updates each patient's hypers online under
    the test prior (A-elements that are zero in the mode kernel stay
    clamped) with the experiment's learning rate and momentum. Over a
    mesh every bucket is sharded as `train_cohort` shards
    (medgp_tpu/parallel/runner.py:471-525), and every `test` record
    carries devices=W.

    etime keeps the JAX package's meaning: the bucket's wall time,
    transfers and synchronisation included, divided by its predictions.
    Each `test` record (one per bucket and mode) carries what the table of
    spans and counters (utils/metrics.py) gained in it.
    """
    unknown = [m for m in modes if m not in TEST_MODES]
    if unknown:
        raise ValueError(f"unknown test modes {unknown}; expected {TEST_MODES}")
    device = torch.device(device)
    mesh = mesh_or_none(use_mesh, device)
    W = _world(mesh)
    write = _writes(mesh)
    free = _plan_bytes(mesh)
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
                for m in modes if write else ():
                    formats.write_test_result(
                        cfg.exp_test_dir, m, rec.pan,
                        np.zeros(0, int), np.zeros(0), np.zeros(0),
                        np.zeros(0, int), np.zeros(0), flag=False,
                    )

        batches = pack_patients(
            [r for r in sel if r.n_obs > 0], max_batch=round_up(MAX_BATCH, W), device=device,
            free_bytes=free,
        )
        for b in batches:
            total_obs = int(np.sum(b.mask))
            res_by_mode, etime_by_mode = {}, {}
            for m in modes:
                before = snapshot()
                with span("medgp.test.bucket"):
                    t0 = time.perf_counter()
                    res = impute_bucket(
                        spec, theta, b, device, update=m == "mean_w_update",
                        prior=prior, learn_rate=cfg.online_learn_rate,
                        momentum=cfg.online_momentum, mesh=mesh,
                    )
                    res_by_mode[m] = OnlineResult(
                        *(x.cpu() for x in res)  # waits for the device
                    )
                    dt = time.perf_counter() - t0
                etime_by_mode[m] = dt / max(total_obs, 1)
                log.info(
                    "tested bucket fold=%s mode=%s n_max=%d B=%d on %d device(s) (%s) "
                    "in %.2fs", fold, m, b.n_max, len(b), W, device, dt,
                )
                metrics.write(
                    "test", fold=int(fold), mode=m, n_max=b.n_max,
                    batch=len(b), devices=W, device=str(device), seconds=dt,
                    predictions=total_obs,
                    sec_per_prediction=etime_by_mode[m], **since(before),
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
                    if write:
                        formats.write_test_result(
                            cfg.exp_test_dir, m, pan,
                            feat, pred, err, ci, etime, flag=True, var=pvar,
                        )
                out[pan] = entry
    barrier(mesh)
    return out
