#!/usr/bin/env python3
r"""`run --sampler hmc`'s stages in both packages on the CPU, from the same
MAP train files: is the port's clustering on posterior means within the
JAX package's own spread?

    python3 tools/sampler_run_arms.py [--patients 16] [--port-seeds 0 1 2] \
        [--jax-keys 0 1 2] [--jobs 3] [--work DIR]

The cohort is chip_smoke.py's seed-44 synthetic cohort at full width
(LMC-SM Q=5, D=24, R=8, hier-gamma), cut to its first `--patients`
patients of at most 256 observations, two CV folds. The port's CLI
`train --device cpu` fits the MAP files once, at chip_smoke.py's
TRAIN_OPT budgets. Then every arm runs in a process of its own, on a copy
of the experiment with those train files:

  * a sampler arm: the package's `hmc_cohort` (what CLI `hmc --sampler
    hmc` runs, with the seed or key given: 2 chains, 16 warmup + 16 draws,
    8 leapfrog steps, chip_smoke.py's SAMPLER_BUDGET), each patient's
    posterior mean (`invariant_posterior_mean`) put in place of its MAP
    hypers (the handoff of `run --sampler`), then the package's CLI
    `kernclust` (every fold), `test` (both modes) and `eval`;
  * a MAP arm per package: the same stages on the MAP hypers.

It prints, and writes to WORK/result.json, each arm's MAE +- SE (over the
per-(patient, feature) MAE files) per test mode, each package's spread
over its sampler arms, and per patient how far the two packages'
posterior means lie apart beside their own arm-to-arm spread: `ratio` =
the mean squared distance between a port arm's and a JAX arm's mean over
the sum of both packages' per-coordinate variances across arms, on the
natural-scale invariants (noise std, mu, v, B_q = A A^T + diag(kappa));
near 1 when both sample one posterior, well above it when they do not.
The parent process imports only the port; the JAX arms import only the
JAX package. Working files go to .chip_smoke/sampler_arms/ (gitignored).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
WORK = os.path.join(ROOT, ".chip_smoke", "sampler_arms")
TEST_MODES = ("mean_wo_update", "mean_w_update")
SEED, Q, D, R = 44, 5, 24, 8  # chip_smoke.py's cohort and width
N_MAX = 256
FOLDS = 2
TRAIN_OPT = dict(
    random_init_num=16, random_seed=718, top_iteration_num=2,
    iteration_num_per_update=30, online_learn_rate=1e-5, online_momentum=0.9,
)  # chip_smoke.py's TRAIN_OPT
HMC = dict(num_chains=2, num_warmup=16, num_samples=16, num_leapfrog=8, sampler="hmc")


# --------------------------------------------------------------------------
# one arm, in a process of its own
# --------------------------------------------------------------------------

def _swap_in_posterior_means(cfg, pans, post):
    """`run --sampler`'s handoff through the files: each sampled patient's
    posterior mean in place of its MAP hypers."""
    from medgp_tpu_torch.data import formats  # numpy only

    for pan in pans:
        if pan in post and "post_mean" in post[pan]:
            formats.write_double_bin(formats.train_paths(cfg.exp_train_dir, pan)["hyp"],
                                     np.asarray(post[pan]["post_mean"], np.float64))


def arm_main(pkg: str, cfg_path: str, seed) -> dict:
    t0 = time.time()
    out = {}
    if pkg == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from medgp_tpu.cli.main import main as cli
        from medgp_tpu.config.experiment import ExperimentConfig
        from medgp_tpu.data.cohort import load_cohort
        from medgp_tpu.parallel.runner import hmc_cohort

        on_cpu, cpu_flag = {}, []  # the platform is set above
    else:
        from medgp_tpu_torch.cli.main import main as cli
        from medgp_tpu_torch.config.experiment import ExperimentConfig
        from medgp_tpu_torch.data.cohort import load_cohort
        from medgp_tpu_torch.parallel.runner import hmc_cohort

        on_cpu, cpu_flag = dict(device="cpu"), ["--device", "cpu"]
    cfg = ExperimentConfig.from_json(cfg_path)
    if seed is not None:
        recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
        post = hmc_cohort(cfg, recs, seed=seed, **HMC, **on_cpu)
        _swap_in_posterior_means(cfg, cfg.pans(), post)
        out["sampled"] = sum("post_mean" in v for v in post.values())
        out["hmc_seconds"] = time.time() - t0
    cli(["kernclust", "--cfg", cfg_path, *cpu_flag])
    cli(["test", "--cfg", cfg_path, *cpu_flag])
    for mode in TEST_MODES:
        cli(["eval", "--cfg", cfg_path, "--test-mode", mode])
    out["seconds"] = time.time() - t0
    return out


# --------------------------------------------------------------------------
# the parent: stage, train once, run the arms, compare
# --------------------------------------------------------------------------

def _cli(argv):
    from medgp_tpu_torch.cli.main import main as cli

    cli(argv)


def stage(work: str, n_patients: int):
    """The cut cohort under work/data/synth, and the experiment "map"
    generated over it; returns its exp_setup.json."""
    from medgp_tpu_torch.data.synthetic import sample_cohort, write_reference_format_cohort
    from medgp_tpu_torch.models.params import LMCSMSpec

    feature_config = os.path.join(ROOT, "medgp_tpu_torch", "examples", "feature_all.json")
    with open(feature_config) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    recs = sample_cohort(SEED, LMCSMSpec(Q, D, R), 64, n_clusters=4, n_obs_range=(100, 400))
    recs = [r for r in recs if r.n_obs <= N_MAX][:n_patients]
    write_reference_format_cohort(os.path.join(work, "data", "synth"), recs, features)
    with open(os.path.join(work, "opt.json"), "w") as f:
        json.dump(TRAIN_OPT, f)
    return generate(work, "map"), [r.n_obs for r in recs]


def generate(work: str, prefix: str) -> str:
    _cli([
        "generate", "--data-root", os.path.join(work, "data"), "--exp-root",
        os.path.join(work, "exp"), "--cohort", "synth", "--feature-config",
        os.path.join(ROOT, "medgp_tpu_torch", "examples", "feature_all.json"),
        "--opt-config", os.path.join(work, "opt.json"), "--Q", str(Q), "--R", str(R),
        "--cv-fold-num", str(FOLDS), "--exp-prefix", prefix,
    ])
    return os.path.join(work, "exp", f"{prefix}_k7_q{Q}_r{R}_p2_e0.01", "config",
                        "exp_setup.json")


def run_child(work: str, name: str, argv) -> None:
    """A child process with its log in work/{name}.log; raises if it fails."""
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONHASHSEED="0", OMP_NUM_THREADS="2",
               MEDGP_PLATFORM="cpu", JAX_PLATFORMS="cpu",
               MEDGP_COMPILE_CACHE=os.path.join(work, "jax_cache"))
    log = os.path.join(work, f"{name}.log")
    with open(log, "w") as f:
        rc = subprocess.run([sys.executable, *argv], cwd=ROOT, env=env, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    if rc:
        with open(log) as f:
            tail = f.read()[-3000:]
        raise RuntimeError(f"{name} exited {rc}; the end of {log}:\n{tail}")


def natural(spec, theta):
    """The natural-scale invariants of a flat LMC-SM theta: noise std, mu,
    v and the upper triangles of B_q = A_q A_q^T + diag(kappa_q)."""
    import torch

    p = spec.unpack(torch.as_tensor(theta, dtype=torch.float64))
    B = spec.coregional_B(p["A"], p["kappa"]).numpy()
    iu = np.triu_indices(spec.D)
    return np.concatenate([p["noise_std"].numpy(), p["mu"].numpy(), p["v"].numpy(),
                           B[:, iu[0], iu[1]].ravel()])


def compare_means(spec, pans, means):
    """Per patient: the `ratio` of the module docstring, and the squared
    distance of the arms' mean from the MAP point over the same variance
    sum."""
    rows = {}
    for pan in pans:
        x = np.stack([natural(spec, m[pan]) for m in means["port"]])
        y = np.stack([natural(spec, m[pan]) for m in means["jax"]])
        var = x.var(0, ddof=1) + y.var(0, ddof=1)
        cross = np.mean([np.sum((a - b) ** 2) for a in x for b in y])
        rows[pan] = dict(ratio=float(cross / var.sum()),
                         moved=float(np.sum((np.concatenate([x, y]).mean(0) - natural(
                             spec, means["map"][pan])) ** 2) / var.sum()))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--patients", type=int, default=16)
    p.add_argument("--port-seeds", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--jax-keys", type=int, nargs="+", default=[0, 1, 2])
    p.add_argument("--jobs", type=int, default=3, help="arms run at once")
    p.add_argument("--work", default=WORK)
    p.add_argument("--arm", choices=("port", "jax"), help=argparse.SUPPRESS)
    p.add_argument("--cfg", help=argparse.SUPPRESS)
    p.add_argument("--seed", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--result", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.arm:
        out = arm_main(args.arm, args.cfg, args.seed)
        with open(args.result, "w") as f:
            json.dump(out, f)
        return 0

    from medgp_tpu_torch.config.experiment import ExperimentConfig
    from medgp_tpu_torch.data import formats
    from medgp_tpu_torch.evaluation.evals import mae_mean_se

    work = os.path.abspath(args.work)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.time()
    map_cfg, n_obs = stage(work, args.patients)
    run_child(work, "train", ["-m", "medgp_tpu_torch.cli.main", "train", "--cfg", map_cfg,
                              "--device", "cpu"])
    map_exp = ExperimentConfig.from_json(map_cfg)
    pans, _ = formats.read_train_kernels(map_exp.exp_train_dir, map_exp.pans())
    print(f"trained {len(pans)}/{len(n_obs)} patients (n = {min(n_obs)}..{max(n_obs)}) "
          f"in {time.time() - t0:.0f} s", flush=True)

    arms = ([("port", None), ("jax", None)] + [("port", s) for s in args.port_seeds]
            + [("jax", k) for k in args.jax_keys])

    def one(arm):
        pkg, seed = arm
        name = f"{pkg}_{'map' if seed is None else f's{seed}'}"
        cfg_path = generate(work, name)
        shutil.copytree(map_exp.exp_train_dir, ExperimentConfig.from_json(cfg_path).exp_train_dir,
                        dirs_exist_ok=True)
        result = os.path.join(work, f"{name}.json")
        argv = [os.path.abspath(__file__), "--arm", pkg, "--cfg", cfg_path, "--result", result]
        run_child(work, name, argv + ([] if seed is None else ["--seed", str(seed)]))
        with open(result) as f:
            info = json.load(f)
        cfg = ExperimentConfig.from_json(cfg_path)
        info["mae"] = {m: mae_mean_se(cfg.exp_test_dir, m, cfg.feature_list) for m in TEST_MODES}
        if seed is not None:
            info["means"] = {pan: formats.read_double_bin(os.path.join(
                cfg.exp_train_dir, f"train_hmc_mean_{pan}.bin")) for pan in pans}
        print(f"{name}: MAE {json.dumps(info['mae'])} in {info['seconds']:.0f} s", flush=True)
        return name, info

    with ThreadPoolExecutor(args.jobs) as ex:
        results = dict(ex.map(one, arms))

    spread = {}
    for pkg, seeds in (("port", args.port_seeds), ("jax", args.jax_keys)):
        names = [f"{pkg}_s{s}" for s in seeds]
        spread[pkg] = {m: dict(
            values=[results[n]["mae"][m][0] for n in names],
            min=min(results[n]["mae"][m][0] for n in names),
            max=max(results[n]["mae"][m][0] for n in names),
            std=float(np.std([results[n]["mae"][m][0] for n in names], ddof=1)),
            map=results[f"{pkg}_map"]["mae"][m][0],
        ) for m in TEST_MODES}
    map_means = {pan: formats.read_double_bin(formats.train_paths(
        map_exp.exp_train_dir, pan)["hyp"]) for pan in pans}
    means = {"port": [results[f"port_s{s}"]["means"] for s in args.port_seeds],
             "jax": [results[f"jax_s{k}"]["means"] for k in args.jax_keys], "map": map_means}
    rows = compare_means(map_exp.spec(), pans, means)
    ratios = np.array([r["ratio"] for r in rows.values()])
    summary = dict(
        cohort=dict(patients=len(n_obs), trained=len(pans), n_obs=[min(n_obs), max(n_obs)],
                    Q=Q, D=D, R=R, folds=FOLDS),
        sampler=HMC,
        arms={n: dict(mae=r["mae"], seconds=r["seconds"], sampled=r.get("sampled"))
              for n, r in results.items()},
        spread=spread,
        posterior_means=dict(per_patient=rows, ratio_median=float(np.median(ratios)),
                             ratio_max=float(ratios.max())),
        seconds=time.time() - t0,
    )
    with open(os.path.join(work, "result.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({k: summary[k] for k in ("spread", "seconds")}))
    print(json.dumps(dict(ratio_median=summary["posterior_means"]["ratio_median"],
                          ratio_max=summary["posterior_means"]["ratio_max"],
                          per_patient=rows)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
