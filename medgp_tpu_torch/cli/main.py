"""Command-line interface of the port: `generate` and `test`.

    python -m medgp_tpu_torch.cli.main generate --data-root ... --exp-root ...
    python -m medgp_tpu_torch.cli.main test --cfg .../exp_setup.json --alg gmm

Counterpart of the same subcommands of ``medgp_tpu/cli/main.py``; both
read and write the reference-format artifacts, so either package's
`generate` output drives the other's `test`. `test` runs the
`mean_wo_update` mode on `--device` (default: the first CUDA device when
there is one); the other stages are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time

import numpy as np
import torch

log = logging.getLogger("medgp_tpu_torch")


def _load_cfg(path):
    from medgp_tpu_torch.config.experiment import ExperimentConfig

    if not os.path.exists(path):
        raise SystemExit(
            f"medgp_tpu_torch: config file not found: {path} "
            "(expected the exp_setup.json written by `generate`)"
        )
    return ExperimentConfig.from_json(path)


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


def cmd_test(args):
    if args.mode != "mean_wo_update":
        raise SystemExit(
            f"medgp_tpu_torch: test mode {args.mode} is not ported yet: it "
            "updates the hyperparameters online, which needs the objective "
            "gradient that comes with the training slice"
        )
    from medgp_tpu_torch.data.cohort import load_cohort
    from medgp_tpu_torch.parallel.runner import test_cohort

    cfg = _load_cfg(args.cfg)
    pans = cfg.pans()
    records = load_cohort(
        cfg.data_dir, [args.pan] if args.pan else pans, cfg.feature_list
    )
    if args.fold is not None:
        folds = np.full(len(records), args.fold)
    else:
        cv = cfg.cv_assign()
        index = {p: i for i, p in enumerate(pans)}
        folds = np.asarray([cv[index[r.pan]] for r in records])
    device = torch.device(
        args.device or ("cuda" if torch.cuda.is_available() else "cpu")
    )
    t0 = time.time()
    test_cohort(
        cfg, records, folds=folds, kernclust_alg=args.alg,
        modes=(args.mode,), device=device,
    )
    log.info(
        "tested %d patients on %s in %.1fs",
        len(records), device, time.time() - t0,
    )


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

    s = sub.add_parser("test", help="online one-step-ahead imputation")
    s.add_argument("--cfg", required=True)
    s.add_argument("--pan", default=None, help="single patient id")
    s.add_argument("--fold", type=int, default=None)
    s.add_argument("--alg", default="gmm")
    s.add_argument(
        "--mode", default="mean_wo_update",
        choices=("mean_wo_update", "mean_w_update"),
        help="test mode (only mean_wo_update is ported)",
    )
    s.add_argument(
        "--device", default=None,
        help="torch device (default: cuda when available, else cpu)",
    )
    s.set_defaults(func=cmd_test)
    return p


def main(argv=None):
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    args = build_parser().parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
