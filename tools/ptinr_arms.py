#!/usr/bin/env python3
"""Arms of the port's fused `run` on chip_smoke.py's PT/INR accuracy
cohort (tools/refbudget_run.sh's, at its reduced budgets): one per
random seed.

    python3 tools/ptinr_arms.py [--seeds 718 1 2 3 4 5] [--device cuda]
    python3 tools/ptinr_arms.py --jax-inits --seeds 718 --device cpu
    JAX_PLATFORMS=cpu python3 tools/ptinr_jax_inits.py --seeds 718 1 2 3 4 5 6 7 8 9
    python3 tools/ptinr_arms.py --paired --out chiprun_out/ptinr_paired.json

The cohort and the budgets are chip_smoke.py's (stage_ptinr, PTINR_OPT).
The seed is the experiment's random_seed, which draws the 16 restarts and
the GMM's inits. With --jax-inits the restarts are the JAX package's
draws (tools/ptinr_jax_inits.json), as chip_smoke.py's accuracy phase
trains. For each arm it prints each test mode's MAE +- SE over the 200
per-(patient, feature) MAE values and the stage seconds, then the spread
of the MAEs across arms: how far two arms fall apart beside the
bin-level SE that the accuracy check uses.

--paired runs two arms per seed s (default 718, 1, ..., 9): P_s from the
port's own restart draws and J_s from the JAX package's draws of
jax.random.key(s) (tools/ptinr_jax_inits_seeds.json, written by the
second command above, where JAX is installed), both with random_seed = s,
so that only the 16 restarts differ. Per test mode it prints the mean and
sd (ddof 1) of P and of J, the paired differences d_s = P_s - J_s with
their mean and sd, the paired t rule's verdict (the draws agree if
|mean d| <= 2.262 sd(d) / sqrt(K), K = 10 seeds), the
JAX package's CPU arm's z score in J, and the own-draw gate that
chip_smoke.py takes from J: |MAE - mean_J| <= 3 sd_J sqrt(1 + 1/K).
On the card one arm takes about a minute. Working files go to
.chip_smoke/ (the smoke's own, which its next run clears).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from medgp_tpu_torch.config.experiment import ExperimentConfig  # noqa: E402
from medgp_tpu_torch.evaluation.evals import mae_mean_se  # noqa: E402
from medgp_tpu_torch.parallel.runner import TEST_MODES  # noqa: E402

PAIRED_INITS = os.path.join(ROOT, "tools", "ptinr_jax_inits_seeds.json")
PAIRED_SEEDS = [718, *range(1, 10)]
T_975_9DF = 2.262  # Student's t, two-sided 5%, 9 degrees of freedom (K = 10)


def one_arm(seed: int, device: str, inits=None, prefix: str = "arm") -> dict:
    """The fused `run` with random_seed = seed, from the port's own restart
    draws or, given `inits`, from those."""
    cfg_path, _ = chip_smoke.stage_ptinr(
        f"{prefix}{seed}", dict(chip_smoke.PTINR_OPT, random_seed=seed))
    draws = (chip_smoke.restart_draws(inits) if inits is not None
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


def paired_table(P: dict, J: dict) -> dict:
    """Per mode: P's and J's mean and sd, the paired differences, the t
    rule's verdict, the JAX CPU arm's z score in J and the own-draw gate."""
    K, t = len(P), T_975_9DF
    table = {}
    for mode in TEST_MODES:
        p = np.array([P[s][mode][0] for s in P])
        j = np.array([J[s][mode][0] for s in P])
        d = p - j
        lim = t * d.std(ddof=1) / np.sqrt(K)
        cpu = chip_smoke.JAX_PTINR_MAE[mode]["CPU run"][0]
        table[mode] = dict(
            K=K, P_mean=p.mean(), P_sd=p.std(ddof=1), J_mean=j.mean(),
            J_sd=j.std(ddof=1), d=d.tolist(), d_mean=d.mean(), d_sd=d.std(ddof=1),
            t=t, rule_limit=lim, agree=bool(abs(d.mean()) <= lim),
            jax_cpu_arm=cpu, jax_cpu_z=(cpu - j.mean()) / j.std(ddof=1),
            gate_halfwidth=3 * j.std(ddof=1) * np.sqrt(1 + 1 / K))
    return table


def paired(seeds, device: str) -> dict:
    chip_smoke.check(len(seeds) == 10, "the paired rule is written for 10 seeds")
    with open(PAIRED_INITS) as f:
        jax_draws = json.load(f)["inits"]
    P, J = {}, {}
    for seed in seeds:
        P[seed] = one_arm(seed, device, prefix="P")
        print(f"P seed {seed}: {json.dumps(P[seed])}", flush=True)
        J[seed] = one_arm(seed, device, torch.tensor(jax_draws[str(seed)]), prefix="J")
        print(f"J seed {seed}: {json.dumps(J[seed])}", flush=True)
    table = paired_table(P, J)
    for mode, r in table.items():
        print(f"{mode}: K={r['K']}; P mean {r['P_mean']:.4f} sd {r['P_sd']:.4f}; "
              f"J mean {r['J_mean']:.4f} sd {r['J_sd']:.4f}; d = P - J mean "
              f"{r['d_mean']:+.4f} sd {r['d_sd']:.4f}; |mean d| against "
              f"{r['t']:.4g} sd(d)/sqrt(K) = {r['rule_limit']:.4f}: "
              f"{'agree' if r['agree'] else 'DISAGREE'}; JAX CPU arm "
              f"{r['jax_cpu_arm']:.4f} at z = {r['jax_cpu_z']:+.2f} in J; own-draw "
              f"gate mean_J +- {r['gate_halfwidth']:.4f}", flush=True)
    return dict(P=P, J=J, table=table)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seeds", type=int, nargs="+")
    p.add_argument("--device", default="cuda")
    p.add_argument("--jax-inits", action="store_true",
                   help="train from the JAX package's restart draws")
    p.add_argument("--paired", action="store_true",
                   help="per seed an arm from each package's draws (see above)")
    p.add_argument("--out", help="write the arms as JSON here")
    args = p.parse_args(argv)
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    if args.device.startswith("cuda"):
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    if args.paired:
        out = paired(args.seeds or PAIRED_SEEDS, args.device)
    else:
        arms = out = {}
        inits = chip_smoke.jax_ptinr_inits() if args.jax_inits else None
        for seed in args.seeds or [718, 1, 2, 3, 4, 5]:
            arms[seed] = one_arm(seed, args.device, inits)
            print(f"seed {seed}: {json.dumps(arms[seed])}", flush=True)
        for mode in TEST_MODES:
            m = np.array([a[mode][0] for a in arms.values()])
            spread = f"std (ddof 1) {m.std(ddof=1):.4f}, " if len(m) > 1 else ""
            print(f"{mode}: MAE over {len(m)} arms mean {m.mean():.4f}, {spread}range "
                  f"{m.min():.4f} - {m.max():.4f}; mean bin-level SE "
                  f"{np.mean([a[mode][1] for a in arms.values()]):.4f}")
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1, default=float)
    return 0


if __name__ == "__main__":
    sys.exit(main())
