"""Command-line interface of the port: the reference's stages, staged or
fused.

    python -m medgp_tpu_torch.cli.main generate  --data-root ... --exp-root ...
    python -m medgp_tpu_torch.cli.main train     --cfg .../exp_setup.json
    python -m medgp_tpu_torch.cli.main kernclust --cfg ... [--fold -1] --alg gmm
    python -m medgp_tpu_torch.cli.main test      --cfg ... --alg gmm [--mode M]
    python -m medgp_tpu_torch.cli.main eval      --cfg ... --test-mode mean_w_update
    python -m medgp_tpu_torch.cli.main hmc       --cfg ... [--sampler hmc|nuts|vi]
    python -m medgp_tpu_torch.cli.main run       --cfg ... [--sampler S]  # one process
    torchrun --nproc-per-node 4 -m medgp_tpu_torch.cli.main run --cfg ...  # 4 GPUs

Counterpart of the same subcommands of ``medgp_tpu/cli/main.py``; all
read and write the reference-format artifacts, so either package's output
drives the other's next stage. `train`, `kernclust`, `test`, `hmc` and
`run` run on the CUDA card; without one they stop with a message unless
`--device cpu` asks for the CPU (the kernels' plain twins). `eval` is host
numpy. `test` runs both test modes unless `--mode` picks one. `train` and
`run` train LMC-SM patients above the large-patient threshold
(`--large-threshold`, default the config's) by row blocks.

Under `torchrun` with more than one process, each process is one rank on
cuda:LOCAL_RANK (or the CPU) and joins the process group over NCCL (gloo
on the CPU, or where `--dist-backend gloo` asks for it, e.g. several ranks
sharing one card); `train`, `test`, `hmc` and `run` then shard every
bucket's patients over the ranks, rank 0 alone writes the files (and
runs `kernclust`), and the others wait for its writes. `run` then takes
each fold's log noise modes from one all-gather over the ranks
(medgp_tpu/cli/main.py:236-266).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch
import torch.distributed

from medgp_tpu_torch.parallel.launch import BACKENDS, init_distributed, rank_device, world_from_env
from medgp_tpu_torch.parallel.runner import SAMPLERS, TEST_MODES

log = logging.getLogger("medgp_tpu_torch")


def _load_cfg(path):
    from medgp_tpu_torch.config.experiment import ExperimentConfig

    if not os.path.exists(path):
        raise SystemExit(
            f"medgp_tpu_torch: config file not found: {path} "
            "(expected the exp_setup.json written by `generate`)"
        )
    return ExperimentConfig.from_json(path)


def _load_records(cfg, pans=None):
    """The cohort's records, through the native loader
    (`runtime/bindings.py`) where it builds, else the Python one
    (medgp_tpu/cli/main.py:43-53); both give the same bits. Logs which
    loader ran and how many observations it read."""
    from medgp_tpu_torch.data.cohort import load_cohort
    from medgp_tpu_torch.runtime import bindings

    pans = cfg.pans() if pans is None else pans
    t0 = time.time()
    if bindings.native_available():
        loader, records = "native", bindings.load_cohort_native(
            cfg.data_dir, pans, cfg.feature_list)
    else:
        loader, records = "python", load_cohort(cfg.data_dir, pans, cfg.feature_list)
    log.info(
        "loaded %d patients (%d observations) with the %s loader in %.2fs",
        len(records), sum(r.n_obs for r in records), loader, time.time() - t0,
    )
    return records


def cmd_generate(args):
    from medgp_tpu_torch.config.experiment import generate_experiment

    with open(args.feature_config) as f:
        feature_list = json.load(f)["feature_list"]
    opt = {}
    if args.opt_config:
        with open(args.opt_config) as f:
            opt = json.load(f)
    cfg = generate_experiment(
        data_root=args.data_root,
        exp_root=args.exp_root,
        cohort=args.cohort,
        feature_list=[feat["index"] for feat in feature_list],
        kernel=args.kernel,
        prior=args.prior,
        Q=args.Q, R=args.R, eta=args.eta, beta_lam=args.beta_lam,
        cv_fold_num=args.cv_fold_num,
        cv_seed=args.cv_seed,
        exp_prefix=args.exp_prefix,
        opt_config=opt,
    )
    print(cfg.exp_top_dir)


def _device(args) -> torch.device:
    """The device a stage runs on: this rank's CUDA card
    (`launch.rank_device`) unless `--device` names another; asking for the
    card without one stops with a message."""
    device = rank_device(args.device or "cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"medgp_tpu_torch {args.command}: no CUDA device "
            "(torch.cuda.is_available() is false); pass --device cpu to run "
            "on the CPU"
        )
    return device


def cmd_train(args):
    from medgp_tpu_torch.parallel.runner import train_cohort

    device = _device(args)
    cfg = _load_cfg(args.cfg)
    records = _load_records(cfg, [args.pan] if args.pan else None)
    t0 = time.time()
    out = train_cohort(
        cfg, records, n_restarts=args.restarts, max_batch=args.max_batch,
        large_threshold=args.large_threshold, ckpt_dir=args.ckpt_dir,
        device=device,
    )
    ok = sum(1 for r in out.values() if r["flag"])
    log.info(
        "trained %d/%d patients on %s in %.1fs",
        ok, len(out), device, time.time() - t0,
    )


def cmd_test(args):
    from medgp_tpu_torch.parallel.runner import test_cohort

    device = _device(args)
    cfg = _load_cfg(args.cfg)
    pans = cfg.pans()
    records = _load_records(cfg, [args.pan] if args.pan else pans)
    if args.fold is not None:
        folds = np.full(len(records), args.fold)
    else:
        cv = cfg.cv_assign()
        index = {p: i for i, p in enumerate(pans)}
        folds = np.asarray([cv[index[r.pan]] for r in records])
    t0 = time.time()
    test_cohort(
        cfg, records, folds=folds, kernclust_alg=args.alg,
        modes=TEST_MODES if args.mode is None else (args.mode,), device=device,
    )
    log.info(
        "tested %d patients on %s in %.1fs",
        len(records), device, time.time() - t0,
    )


def cmd_kernclust(args):
    from medgp_tpu_torch.cluster.pipeline import kernel_clustering_fold
    from medgp_tpu_torch.parallel.mesh import barrier
    from medgp_tpu_torch.parallel.runner import mesh_or_none, stage_metrics

    device = _device(args)
    cfg = _load_cfg(args.cfg)
    mesh = mesh_or_none(None, device)
    folds = [args.fold] if args.fold is not None else range(-1, cfg.cv_fold_num)
    metrics = stage_metrics(cfg)
    cv = cfg.cv_assign()
    for fold in folds if mesh is None or mesh.rank == 0 else ():
        _, newQ = kernel_clustering_fold(
            cfg.spec(), cfg.exp_train_dir, cfg.exp_kernel_dir, cfg.pans(), cv,
            fold, algorithm=args.alg, seed=cfg.random_seed, metrics=metrics,
            device=device,
        )
        log.info("fold %d: %d mode mixture components", fold, newQ)
    barrier(mesh)


def cmd_eval(args):
    from medgp_tpu_torch.evaluation.evals import eval_cohort, summarize
    from medgp_tpu_torch.parallel.runner import stage_metrics

    cfg = _load_cfg(args.cfg)
    s = summarize(eval_cohort(
        cfg.data_dir, cfg.exp_test_dir, args.test_mode, cfg.feature_list,
        cfg.pans(), metrics=stage_metrics(cfg),
    ))
    log.info(
        "%s: cohort MAE=%.4f CI-coverage=%.2f%%",
        args.test_mode, s["mae"], s["ci_ratio"],
    )
    print(json.dumps(s))


def cmd_hmc(args):
    from medgp_tpu_torch.parallel.runner import hmc_cohort

    device = _device(args)
    cfg = _load_cfg(args.cfg)
    records = _load_records(cfg, [args.pan] if args.pan else None)
    t0 = time.time()
    out = hmc_cohort(
        cfg, records, num_chains=args.chains, num_warmup=args.warmup,
        num_samples=args.samples, num_leapfrog=args.leapfrog,
        init_step_size=args.step_size, sampler=args.sampler,
        max_depth=args.max_depth, device=device,
    )
    log.info(
        "sampled %d/%d patients on %s in %.1fs",
        len(out), len(records), device, time.time() - t0,
    )


def _fold_noise_modes(cfg, mesh, trained, hyps):
    """(n_folds + 1, D) log noise modes of every fold (row f; the last row
    is fold -1) over the ranks (medgp_tpu/cli/main.py:236-266): hypers,
    flags and fold ids padded to a multiple of the world, each rank's
    slice into one all-gather."""
    from medgp_tpu_torch.parallel.mesh import local_rows, population_noise_modes_by_fold

    fold_of = {p: int(f) for p, f in zip(cfg.pans(), cfg.cv_assign())}
    P, pad = len(trained), (-len(trained)) % mesh.world
    th = np.concatenate([hyps, np.zeros((pad, hyps.shape[1]))]).astype(np.float32)
    fl = np.concatenate([np.ones(P), np.zeros(pad)]).astype(np.float32)
    cv = np.concatenate([[fold_of[p] for p in trained], np.full(pad, -2)]).astype(np.int32)
    fn = population_noise_modes_by_fold(cfg.spec(), mesh, cfg.cv_fold_num)
    return fn(*(local_rows(mesh, torch.as_tensor(a, device=mesh.device))
                for a in (th, fl, cv))).double().cpu().numpy()


def cmd_run(args):
    """Fused pipeline: train [-> sampler] -> kernclust (every fold, from the
    hypers in memory) -> test in both modes -> eval of both modes. With
    `--sampler`, posterior inference runs after training and clustering
    takes each sampled patient's posterior-mean hypers in place of its MAP
    point. Files are still written at every stage boundary. One `run`
    record in log/metrics.jsonl carries each stage's seconds.

    Over several ranks, train, the sampler and test shard every bucket,
    each fold's LMC-SM noise-mode block comes from one all-gather
    (`_fold_noise_modes`), rank 0 clusters, evaluates and prints the
    summary, and every rank waits for rank 0's files before the next stage
    reads them."""
    from medgp_tpu_torch.cluster.pipeline import kernel_clustering_fold_in_memory
    from medgp_tpu_torch.evaluation.evals import eval_cohort, summarize
    from medgp_tpu_torch.models.params import LMCSMSpec
    from medgp_tpu_torch.parallel.mesh import barrier
    from medgp_tpu_torch.parallel.runner import (
        hmc_cohort, mesh_or_none, stage_metrics, test_cohort, train_cohort,
    )

    device = _device(args)
    cfg = _load_cfg(args.cfg)
    mesh = mesh_or_none(None, device)
    lead = mesh is None or mesh.rank == 0
    pans = cfg.pans()
    seconds = {}
    t0 = time.time()
    records = _load_records(cfg, pans)
    tout = train_cohort(cfg, records, n_restarts=args.restarts, device=device)
    seconds["train"] = time.time() - t0
    log.info("[run] train done at %.1fs", time.time() - t0)

    # in cohort order, as the file-based `kernclust` reads them, so that the
    # handoff gives the same GMM rows (and draws) as the files would
    trained = [p for p in pans if p in tout and tout[p]["flag"]]
    if not trained:
        raise RuntimeError(
            "no successfully trained patients - nothing to cluster "
            "(check train_flag_* / data quality: >=2 obs per feature)"
        )
    hyps = np.stack([tout[p]["theta"] for p in trained])
    if args.sampler != "none":
        t1 = time.time()
        trained_set = set(trained)
        sout = hmc_cohort(
            cfg, [r for r in records if r.pan in trained_set],
            num_chains=args.chains, num_warmup=args.warmup,
            num_samples=args.samples, sampler=args.sampler, device=device,
        )
        # clustering takes the posterior mean in place of the MAP point
        n_post = 0
        for i, p in enumerate(trained):
            if "post_mean" in sout.get(p, {}):
                hyps[i] = sout[p]["post_mean"]
                n_post += 1
        seconds["sampler"] = time.time() - t1
        log.info(
            "[run] %s posterior means for %d/%d patients at %.1fs",
            args.sampler, n_post, len(trained), time.time() - t0,
        )
    metrics = stage_metrics(cfg)
    cv = cfg.cv_assign()
    t1 = time.time()
    noise_modes = None
    if mesh is not None and isinstance(cfg.spec(), LMCSMSpec):
        noise_modes = _fold_noise_modes(cfg, mesh, trained, hyps)
        log.info("[run] noise modes over %d ranks (%d folds + all): %s",
                 mesh.world, cfg.cv_fold_num, np.round(noise_modes, 4).tolist())
    for fold in range(-1, cfg.cv_fold_num) if lead else ():
        kernel_clustering_fold_in_memory(
            cfg.spec(), cfg.exp_kernel_dir, trained, hyps, cv, pans, fold,
            algorithm=args.alg, seed=cfg.random_seed, metrics=metrics,
            device=device,
            noise_mode=None if noise_modes is None else noise_modes[fold],
        )
    barrier(mesh)
    seconds["kernclust"] = time.time() - t1
    log.info("[run] kernclust done at %.1fs", time.time() - t0)

    t1 = time.time()
    index = {p: i for i, p in enumerate(pans)}
    folds = np.asarray([cv[index[r.pan]] for r in records])
    test_cohort(cfg, records, folds=folds, kernclust_alg=args.alg, device=device)
    seconds["test"] = time.time() - t1
    log.info("[run] test done at %.1fs", time.time() - t0)
    if not lead:
        return

    t1 = time.time()
    summary = {
        mode: summarize(eval_cohort(
            cfg.data_dir, cfg.exp_test_dir, mode, cfg.feature_list, pans,
            metrics=metrics,
        ))
        for mode in TEST_MODES
    }
    seconds["eval"] = time.time() - t1
    metrics.write(
        "run", device=str(device), devices=1 if mesh is None else mesh.world,
        **{f"{k}_seconds": v for k, v in seconds.items()},
        seconds=time.time() - t0,
    )
    log.info("[run] done in %.1fs: %s", time.time() - t0, summary)
    print(json.dumps(summary))


def build_parser():
    p = argparse.ArgumentParser(prog="medgp_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="create an experiment directory")
    g.add_argument("--data-root", required=True)
    g.add_argument("--exp-root", required=True)
    g.add_argument("--cohort", required=True)
    g.add_argument("--feature-config", required=True)
    g.add_argument("--opt-config", default=None)
    g.add_argument("--kernel", default="LMC-SM")
    g.add_argument("--prior", default="hier-gamma")
    g.add_argument("--Q", type=int, default=5)
    g.add_argument("--R", type=int, default=8)
    g.add_argument("--eta", type=float, default=0.01)
    g.add_argument("--beta-lam", type=float, default=0.01)
    g.add_argument("--cv-fold-num", type=int, default=10)
    g.add_argument("--cv-seed", type=int, default=718)
    g.add_argument("--exp-prefix", default="exp_0000")
    g.set_defaults(func=cmd_generate)

    device_help = (
        "torch device (default: cuda, this rank's card under torchrun; cpu runs "
        "the plain twins)"
    )
    backend_help = (
        "torch.distributed backend under torchrun (default: nccl on a CUDA "
        "device, gloo on the CPU; gloo lets several ranks share one card)"
    )
    r = sub.add_parser("train", help="per-patient MAP training")
    r.add_argument("--cfg", required=True)
    r.add_argument("--pan", default=None, help="single patient id")
    r.add_argument("--restarts", type=int, default=None)
    r.add_argument("--max-batch", type=int, default=128)
    r.add_argument(
        "--large-threshold", type=int, default=None,
        help="n_obs above which an LMC-SM patient trains by row blocks "
        "(default: cfg.large_patient_threshold)",
    )
    r.add_argument(
        "--ckpt-dir", default=None,
        help="per-bucket checkpoint dir: a re-run restores the finished "
        "buckets (utils/checkpoints.py)",
    )
    r.add_argument("--device", default=None, help=device_help)
    r.add_argument("--dist-backend", default=None, choices=BACKENDS, help=backend_help)
    r.set_defaults(func=cmd_train)

    k = sub.add_parser("kernclust", help="population mode kernels per fold")
    k.add_argument("--cfg", required=True)
    k.add_argument("--fold", type=int, default=None, help="default: all folds")
    k.add_argument("--alg", default="gmm")
    k.add_argument("--device", default=None, help=device_help)
    k.add_argument("--dist-backend", default=None, choices=BACKENDS, help=backend_help)
    k.set_defaults(func=cmd_kernclust)

    s = sub.add_parser("test", help="online one-step-ahead imputation")
    s.add_argument("--cfg", required=True)
    s.add_argument("--pan", default=None, help="single patient id")
    s.add_argument("--fold", type=int, default=None)
    s.add_argument("--alg", default="gmm")
    s.add_argument(
        "--mode", default=None, choices=TEST_MODES,
        help="one test mode (default: both, mean_wo_update then "
        "mean_w_update, which updates the hypers online)",
    )
    s.add_argument("--device", default=None, help=device_help)
    s.add_argument("--dist-backend", default=None, choices=BACKENDS, help=backend_help)
    s.set_defaults(func=cmd_test)

    e = sub.add_parser("eval", help="per-feature MAE / CI coverage / NLL")
    e.add_argument("--cfg", required=True)
    e.add_argument("--test-mode", required=True, choices=TEST_MODES)
    e.set_defaults(func=cmd_eval)

    h = sub.add_parser(
        "hmc", help="posterior sampling over trained hypers (post-MAP)"
    )
    h.add_argument("--cfg", required=True)
    h.add_argument("--pan", default=None, help="single patient id")
    h.add_argument("--chains", type=int, default=4)
    h.add_argument("--warmup", type=int, default=300)
    h.add_argument("--samples", type=int, default=300)
    h.add_argument("--leapfrog", type=int, default=16)
    h.add_argument(
        "--sampler", choices=SAMPLERS, default="hmc",
        help="hmc = jittered fixed trajectories; vi = mean-field ADVI "
        "(--warmup steps of ELBO ascent, --samples draws); nuts = adaptive "
        "trajectory lengths (iterative tree)",
    )
    h.add_argument(
        "--max-depth", type=int, default=6,
        help="NUTS tree depth bound (<= 2^depth - 1 gradient evals/draw)",
    )
    h.add_argument("--step-size", type=float, default=0.005)
    h.add_argument("--device", default=None, help=device_help)
    h.add_argument("--dist-backend", default=None, choices=BACKENDS, help=backend_help)
    h.set_defaults(func=cmd_hmc)

    u = sub.add_parser("run", help="fused train[+sampler]+kernclust+test+eval")
    u.add_argument("--cfg", required=True)
    u.add_argument("--alg", default="gmm")
    u.add_argument("--restarts", type=int, default=None)
    u.add_argument(
        "--sampler", choices=("none",) + SAMPLERS, default="none",
        help="run posterior inference after MAP and feed posterior-mean "
        "hypers into clustering instead of the MAP point",
    )
    u.add_argument("--chains", type=int, default=4)
    u.add_argument("--warmup", type=int, default=200)
    u.add_argument("--samples", type=int, default=200)
    u.add_argument("--device", default=None, help=device_help)
    u.add_argument("--dist-backend", default=None, choices=BACKENDS, help=backend_help)
    u.set_defaults(func=cmd_run)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    # under torchrun a device stage joins the process group, and leaves it
    # at the end if it started it
    started = (hasattr(args, "dist_backend") and world_from_env() > 1
               and not torch.distributed.is_initialized())
    if started:
        init_distributed(backend=args.dist_backend, device=_device(args))
    try:
        args.func(args)
    finally:
        if started:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
