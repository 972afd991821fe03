#!/usr/bin/env python3
"""Arms of the port's fused `run` on chip_smoke.py's PT/INR accuracy
cohort (tools/refbudget_run.sh's, at its reduced budgets): one per
random seed.

    python3 tools/ptinr_arms.py [--seeds 718 1 2 3 4 5] [--device cuda]
    python3 tools/ptinr_arms.py --jax-inits --seeds 718 --device cpu

The cohort and the budgets are chip_smoke.py's (stage_ptinr, PTINR_OPT).
The seed is the experiment's random_seed, which draws the 16 restarts and
the GMM's inits. With --jax-inits the restarts are the JAX package's
draws (tools/ptinr_jax_inits.json), as chip_smoke.py's accuracy phase
trains. For each arm it prints each test mode's MAE +- SE over the 200
per-(patient, feature) MAE values and the stage seconds, then the spread
of the MAEs across arms: how far two arms fall apart beside the
bin-level SE that the accuracy check uses. Working files go to
.chip_smoke/ (the smoke's own, which its next run clears).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from medgp_tpu_torch.config.experiment import ExperimentConfig  # noqa: E402
from medgp_tpu_torch.evaluation.evals import mae_mean_se  # noqa: E402
from medgp_tpu_torch.parallel.runner import TEST_MODES  # noqa: E402


def one_arm(seed: int, device: str, jax_inits: bool) -> dict:
    cfg_path, _ = chip_smoke.stage_ptinr(
        f"arm{seed}", dict(chip_smoke.PTINR_OPT, random_seed=seed))
    draws = (chip_smoke.restart_draws(chip_smoke.jax_ptinr_inits()) if jax_inits
             else contextlib.nullcontext())
    with draws:
        chip_smoke.cli(["run", "--cfg", cfg_path, "--device", device])
    cfg = ExperimentConfig.from_json(cfg_path)
    out = {m: mae_mean_se(cfg.exp_test_dir, m, cfg.feature_list) for m in TEST_MODES}
    out["seconds"] = chip_smoke.run_stage_seconds(cfg)
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        out["components"] = [int(r["mixture_num"]) for r in map(json.loads, f)
                             if r["stage"] == "kernclust"]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+", default=[718, 1, 2, 3, 4, 5])
    p.add_argument("--device", default="cuda")
    p.add_argument("--jax-inits", action="store_true",
                   help="train from the JAX package's restart draws")
    args = p.parse_args(argv)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    arms = {}
    for seed in args.seeds:
        arms[seed] = one_arm(seed, args.device, args.jax_inits)
        print(f"seed {seed}: {json.dumps(arms[seed])}", flush=True)
    for mode in TEST_MODES:
        m = np.array([a[mode][0] for a in arms.values()])
        spread = f"std (ddof 1) {m.std(ddof=1):.4f}, " if len(m) > 1 else ""
        print(f"{mode}: MAE over {len(m)} arms mean {m.mean():.4f}, {spread}range "
              f"{m.min():.4f} - {m.max():.4f}; mean bin-level SE "
              f"{np.mean([a[mode][1] for a in arms.values()]):.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
