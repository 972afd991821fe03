#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (medgp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA device and print `nvidia-smi`'s name and power limit;
  2. build the hand-written CUDA kernels from medgp_tpu_torch/csrc with nvcc;
  3. hold each kernel (K1 gram, K3 chol_solve, K5 tri_inv) against its plain
     PyTorch twin on the card at canonical width (LMC-SM Q=5, D=24, R=8),
     including a non-SPD system and the jitter-retry loop, and time both
     with CUDA events;
  4. run the test stage end to end through the port's CLI (`generate`, then
     `test` in mean_wo_update mode) on a 64-patient synthetic cohort with
     the canonical kernel, check every patient's outputs and that the main
     path launched every kernel, and re-run one bucket through the twins
     and in float64;
  5. print one JSON line with the kernels' numbers, then the result line.
It imports nothing of JAX. Working files go to .chip_smoke/ beside it.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

from medgp_tpu_torch.cli.main import main as cli
from medgp_tpu_torch.config.experiment import ExperimentConfig
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import pack_patients
from medgp_tpu_torch.data.synthetic import (
    cluster_thetas, sample_cluster_params, sample_cohort,
    write_reference_format_cohort,
)
from medgp_tpu_torch.infer.online import online_impute, unique_times
from medgp_tpu_torch.models.gp import PatientData
from medgp_tpu_torch.models.params import LMCSMSpec
from medgp_tpu_torch.ops import cuda_build, cuda_chol, cuda_gram
from medgp_tpu_torch.ops.nlml import jittered_chol_solve
from medgp_tpu_torch.parallel.runner import MAX_BATCH

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
SEED = 44
Q, D, R = 5, 24, 8

# Tolerances of the kernel-vs-twin comparisons, both in float32 on the card.
# K1: the kernel forms cos(2 pi mu (t_i - t_j)) from per-row sincos, the
#     twin from the rounded distance; phases reach 2 pi mu t ~ 90 rad, where
#     float32 rounding is ~1e-5 rad, so the bound is relative to max |K|.
K1_REL = 1e-4
# K3/K5: the bounds the Pallas kernels were held to (tests/test_pallas_chol.py)
L_TOL = 1e-5
ALPHA_TOL = 1e-4
LINV_TOL = 1e-4
# One bucket of the test stage, kernels vs twins: LOO predictions divide by
# diag(K_S^{-1}) of systems with condition numbers up to ~1e5 in float32.
PRED_TOL = 1e-2
CI_FLIP_MAX = 1e-3  # share of CI flags allowed to flip at the 1.96-sigma edge


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds per call by CUDA events, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare_gram(rng, dev, Bt, n, masked):
    spec = LMCSMSpec(Q, D, R)
    p = sample_cluster_params(rng, spec)
    t = np.zeros((Bt, n), np.float32)
    meta = np.zeros((Bt, n), np.int32)
    mask = np.zeros((Bt, n), np.float32)
    for i in range(Bt):
        k = int(rng.integers(n // 2 + 1, n + 1))
        t[i, :k] = np.sort(rng.uniform(0, 168, size=k))
        meta[i, :k] = rng.integers(0, D, size=k)
        mask[i, :k] = 1.0
    B = np.stack([p["A"][q] @ p["A"][q].T + np.diag(p["kappa"][q])
                  for q in range(Q)]).astype(np.float32)
    args = [
        torch.as_tensor(t, device=dev), torch.as_tensor(meta, device=dev),
        torch.as_tensor(np.broadcast_to(B, (Bt, Q, D, D)).copy(), device=dev),
        torch.as_tensor(np.tile(p["mu"], (Bt, 1)).astype(np.float32), device=dev),
        torch.as_tensor(np.tile(p["v"], (Bt, 1)).astype(np.float32), device=dev),
    ]
    m = torch.as_tensor(mask, device=dev) if masked else None
    K = cuda_gram.gram_lmcsm_fused(*args, mask=m)
    Kp = cuda_gram.gram_lmcsm_plain(*args, mask=m)
    torch.cuda.synchronize()
    err = float((K - Kp).abs().max())
    scale = float(Kp.abs().max())
    check(bool(torch.isfinite(K).all()), f"K1 n={n}: non-finite output")
    check(err <= K1_REL * scale,
          f"K1 n={n} masked={masked}: max abs err {err} > {K1_REL} * {scale}")
    ms = cuda_ms(lambda: cuda_gram.gram_lmcsm_fused(*args, mask=m), 20)
    plain_ms = cuda_ms(lambda: cuda_gram.gram_lmcsm_plain(*args, mask=m), 5)
    print(f"K1 gram B={Bt} n={n} masked={masked}: max_abs_err={err:.3e} "
          f"(tol {K1_REL:g} x max|K| = {K1_REL * scale:.3e}) "
          f"kernel {ms:.4f} ms, twin {plain_ms:.4f} ms")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)


def spd_batch(gen, dev, Bt, n):
    """Well-conditioned SPD systems (A A^T / n + 0.5 I), except member 1:
    A A^T / n - 2.5 I, which is not SPD at noise multiplier 1 or 2 (noise 1)
    and is at 3. Drawn on the card from the seeded generator `gen`."""
    A = torch.randn((Bt, n, n), generator=gen, device=dev)
    eye = torch.eye(n, device=dev)
    K = A @ A.mT / n + 0.5 * eye
    K[1] -= 3.0 * eye
    noise = torch.full((Bt, n), 0.1, device=dev)
    noise[1] = 1.0
    y = torch.randn((Bt, n), generator=gen, device=dev)
    return K, noise, y


def compare_chol(gen, dev, Bt, n):
    K, noise, y = spd_batch(gen, dev, Bt, n)
    L, alpha, linvd = cuda_chol.chol_solve(K, noise, y)
    Lp, ap, dp = cuda_chol.chol_solve_plain(K, noise, y)
    torch.cuda.synchronize()
    diag = torch.diagonal(L, dim1=-2, dim2=-1)
    check(not bool(torch.isfinite(diag[1]).all()),
          f"K3 n={n}: the non-SPD member has a finite diagonal")
    good = torch.ones(Bt, dtype=torch.bool, device=dev)
    good[1] = False
    check(bool(torch.isfinite(diag[good]).all()),
          f"K3 n={n}: a non-finite diagonal in an SPD member")
    check(bool((torch.triu(L[good], 1) == 0).all()), f"K3 n={n}: upper triangle")
    errs = dict(
        L=float((L[good] - Lp[good]).abs().max()),
        alpha=float((alpha[good] - ap[good]).abs().max()),
        linvd=float((linvd[good] - dp[good]).abs().max()),
    )
    check(torch.allclose(L[good], Lp[good], rtol=L_TOL, atol=L_TOL),
          f"K3 n={n}: L differs from the twin ({errs['L']})")
    check(torch.allclose(alpha[good], ap[good], rtol=ALPHA_TOL, atol=ALPHA_TOL),
          f"K3 n={n}: alpha differs from the twin ({errs['alpha']})")
    check(torch.allclose(linvd[good], dp[good], rtol=LINV_TOL, atol=LINV_TOL),
          f"K3 n={n}: linvd differs from the twin ({errs['linvd']})")

    # the retry loop recovers member 1 at the same multiplier either way
    Lr, ar, dr, okr, mr = jittered_chol_solve(K, y, noise, 10)
    Lq, aq, _, okq, mq = jittered_chol_solve(K, y, noise, 10, plain=True)
    check(bool(okr.all()) and bool(okq.all()), f"retry n={n}: not all recovered")
    check(torch.equal(mr, mq) and int(mr[1]) == 3 and int(mr.max()) == 3,
          f"retry n={n}: multipliers {mr.tolist()} vs twin {mq.tolist()}")
    check(torch.allclose(Lr, Lq, rtol=L_TOL, atol=L_TOL)
          and torch.allclose(ar, aq, rtol=ALPHA_TOL, atol=ALPHA_TOL),
          f"retry n={n}: recovered factor differs from the twin's")

    X = cuda_chol.tri_inv(Lr, dr)
    Xp = cuda_chol.tri_inv_plain(Lr, dr)
    torch.cuda.synchronize()
    errs["Linv"] = float((X - Xp).abs().max())
    check(torch.allclose(X, Xp, rtol=LINV_TOL, atol=LINV_TOL),
          f"K5 n={n}: L^-1 differs from the twin ({errs['Linv']})")
    print(f"K3/K5 B={Bt} n={n}: L err {errs['L']:.3e} (tol {L_TOL:g}), "
          f"alpha err {errs['alpha']:.3e} (tol {ALPHA_TOL:g}), linvd err "
          f"{errs['linvd']:.3e}, L^-1 err {errs['Linv']:.3e} (tol {LINV_TOL:g}); "
          f"non-SPD member -> NaN diagonal -> recovered at mult "
          f"{int(mr[1])} (twin {int(mq[1])})")
    return K, noise, y, Lr, dr, errs


def time_chol(K, noise, y, L, linvd, reps):
    return dict(
        chol_ms=cuda_ms(lambda: cuda_chol.chol_solve(K, noise, y), reps),
        chol_plain_ms=cuda_ms(lambda: cuda_chol.chol_solve_plain(K, noise, y), reps),
        tri_ms=cuda_ms(lambda: cuda_chol.tri_inv(L, linvd), reps),
        tri_plain_ms=cuda_ms(lambda: cuda_chol.tri_inv_plain(L, linvd), reps),
    )


def run_slice(dev):
    """Stage the cohort, `generate` and `test` through the CLI; returns
    (cfg, seconds, counters, outputs)."""
    spec = LMCSMSpec(Q, D, R)
    feature_config = os.path.join(ROOT, "examples", "feature_all.json")
    with open(feature_config) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    check(len(features) == D, f"{feature_config}: expected {D} features")
    t0 = time.perf_counter()
    recs = sample_cohort(SEED, spec, 64, n_clusters=4, n_obs_range=(100, 400))
    write_reference_format_cohort(os.path.join(WORK, "data", "synth"), recs, features)
    print(f"staged {len(recs)} patients ({sum(r.n_obs for r in recs)} observations) "
          f"in {time.perf_counter() - t0:.1f} s")
    cli([
        "generate", "--data-root", os.path.join(WORK, "data"),
        "--exp-root", os.path.join(WORK, "exp"), "--cohort", "synth",
        "--feature-config", feature_config,
        "--opt-config", os.path.join(ROOT, "examples", "opt_prior2.json"),
        "--kernel", "LMC-SM", "--prior", "hier-gamma", "--Q", str(Q),
        "--R", str(R), "--eta", "0.01", "--beta-lam", "0.01",
        "--cv-fold-num", "10", "--exp-prefix", "smoke",
    ])
    cfg_path = os.path.join(
        WORK, "exp", "smoke_k7_q5_r8_p2_e0.01", "config", "exp_setup.json"
    )
    cfg = ExperimentConfig.from_json(cfg_path)
    # mode kernel: cluster 0's ground truth, for "all" and every fold
    theta = cluster_thetas(SEED, spec, 4)[0]
    for fold in range(-1, cfg.cv_fold_num):
        formats.write_mode_kernel(cfg.exp_kernel_dir, fold, "gmm", theta, Q)

    for fn in (cuda_gram.gram_lmcsm_fused, cuda_chol.chol_solve, cuda_chol.tri_inv):
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cli(["test", "--cfg", cfg_path, "--alg", "gmm", "--device", str(dev)])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counters = {
        "gram_lmcsm": cuda_gram.gram_lmcsm_fused.launches,
        "chol_solve": cuda_chol.chol_solve.launches,
        "tri_inv": cuda_chol.tri_inv.launches,
    }

    outputs = {}
    for r in recs:
        paths = formats.test_paths(cfg.exp_test_dir, "mean_wo_update", r.pan)
        missing = [k for k, p in paths.items() if not os.path.exists(p)]
        check(not missing, f"{r.pan}: missing test outputs {missing}")
        flag, res = formats.read_test_result(cfg.exp_test_dir, "mean_wo_update", r.pan)
        check(flag == 1, f"{r.pan}: flag {flag}")
        for k in ("pred", "error", "var", "ci", "feature", "etime"):
            check(len(res[k]) == r.n_obs, f"{r.pan}: {k} has {len(res[k])} "
                  f"entries for {r.n_obs} observations")
        check(bool(np.all(np.isfinite(res["pred"]))), f"{r.pan}: non-finite pred")
        check(bool(np.all(np.isfinite(res["var"]))), f"{r.pan}: non-finite var")
        outputs[r.pan] = res
    return cfg, recs, theta, seconds, counters, outputs


def recheck_bucket(cfg, recs, theta, dev):
    """One bucket of the test stage: kernels vs twins on the card, both vs
    a float64 run of the twins."""
    spec = LMCSMSpec(Q, D, R)
    cv = cfg.cv_assign()
    fold0 = [r for r, f in zip(recs, cv) if f == 0]
    b = max(pack_patients(fold0, max_batch=MAX_BATCH, device=dev),
            key=lambda x: x.n_max)
    ut = np.zeros((len(b), b.n_max), np.float32)
    uv = np.zeros((len(b), b.n_max), bool)
    for i in range(len(b)):
        ut[i], uv[i] = unique_times(b.t[i], b.mask[i], pad_to=b.n_max)

    def run(dtype, plain):
        data = PatientData(
            t=torch.as_tensor(b.t, device=dev, dtype=dtype),
            y=torch.as_tensor(b.y, device=dev, dtype=dtype),
            meta=torch.as_tensor(b.meta, device=dev),
            mask=torch.as_tensor(b.mask, device=dev, dtype=dtype),
        )
        th = torch.as_tensor(np.asarray(theta, np.float32), device=dev).to(dtype)
        return online_impute(
            spec, th, data, torch.as_tensor(ut, device=dev, dtype=dtype),
            torch.as_tensor(uv, device=dev), plain=plain,
        )

    ker = run(torch.float32, False)
    twin = run(torch.float32, True)
    gold = run(torch.float64, True)
    valid = ker.valid
    check(torch.equal(valid, twin.valid), "bucket: valid masks differ")
    d_pred = float((ker.pred - twin.pred)[valid].abs().max())
    d_var = float(((ker.var - twin.var) / twin.var)[valid].abs().max())
    flips = float((ker.ci != twin.ci)[valid].float().mean())
    g_ker = float((ker.pred - gold.pred.float())[valid].abs().max())
    g_twin = float((twin.pred - gold.pred.float())[valid].abs().max())
    print(f"bucket n_max={b.n_max} B={len(b)} ({int(valid.sum())} predictions): "
          f"kernels vs twins max |d pred| {d_pred:.3e} (tol {PRED_TOL:g}), "
          f"max rel d var {d_var:.3e}, CI flips {flips:.2e} (max {CI_FLIP_MAX:g}); "
          f"vs float64 twins: kernels {g_ker:.3e}, float32 twins {g_twin:.3e}")
    check(d_pred <= PRED_TOL, f"bucket: predictions differ by {d_pred}")
    check(d_var <= PRED_TOL, f"bucket: variances differ by {d_var} (relative)")
    check(flips <= CI_FLIP_MAX, f"bucket: {flips} of the CI flags differ")
    return d_pred


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "runs only on a CUDA card", file=sys.stderr)
        return 2

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    dev = torch.device("cuda", 0)
    print(smi[0])  # name, power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    path, build_s, log = cuda_build.build_library()
    print(f"built {os.path.relpath(path, ROOT)} from medgp_tpu_torch/csrc "
          f"with nvcc in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  ptxas:", line.strip())

    rng = np.random.default_rng(SEED)
    k1 = {}
    for n in (128, 256, 512):
        for masked in (False, True):
            k1[(n, masked)] = compare_gram(rng, dev, 32, n, masked)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for n in (128, 256, 512, 1024):
        K, noise, y, L, linvd, errs = compare_chol(gen, dev, 64, n)
        tm = time_chol(K, noise, y, L, linvd, 5)
        print(f"K3/K5 B=64 n={n} times: chol_solve kernel {tm['chol_ms']:.3f} ms, "
              f"twin {tm['chol_plain_ms']:.3f} ms; tri_inv kernel "
              f"{tm['tri_ms']:.3f} ms, twin {tm['tri_plain_ms']:.3f} ms")
        del K, noise, y, L, linvd
    # the test stage's shape: thousands of (patient, timestamp) systems at n=512
    K, noise, y, L, linvd, errs = compare_chol(gen, dev, 1024, 512)
    tm = time_chol(K, noise, y, L, linvd, 3)
    print(f"K3/K5 B=1024 n=512 times: chol_solve kernel {tm['chol_ms']:.3f} ms, "
          f"twin {tm['chol_plain_ms']:.3f} ms; tri_inv kernel {tm['tri_ms']:.3f} "
          f"ms, twin {tm['tri_plain_ms']:.3f} ms")
    del K, noise, y, L, linvd
    torch.cuda.empty_cache()

    cfg, recs, theta, seconds, counters, outputs = run_slice(dev)
    n_pred = sum(len(o["pred"]) for o in outputs.values())
    err = np.concatenate([o["error"] for o in outputs.values()])
    ci = np.concatenate([o["ci"] for o in outputs.values()])
    print(f"test stage (mean_wo_update): {len(outputs)} patients, {n_pred} "
          f"predictions in {seconds:.2f} s = {n_pred / seconds:.1f} predictions/s; "
          f"MAE {np.mean(np.abs(err)):.4f}, CI coverage {100 * np.mean(ci):.2f}%")
    print(f"launches during the test stage: {counters}")
    for name, count in counters.items():
        check(count > 0, f"the test stage never launched {name}")
    recheck_bucket(cfg, recs, theta, dev)

    src = "medgp_tpu_torch/csrc/"
    g = k1[(512, False)]
    kernels = [
        dict(name="gram_lmcsm", route="cuda", source=src + "gram.cuh",
             replaces="medgp_tpu/ops/pallas_gram.py:154",
             launches=counters["gram_lmcsm"], max_abs_err=g["max_abs_err"],
             ms=g["ms"], plain_ms=g["plain_ms"], shape="B=32 n=512 Q=5 D=24"),
        dict(name="chol_solve", route="cuda", source=src + "chol.cuh",
             replaces="medgp_tpu/ops/pallas_chol.py:235",
             launches=counters["chol_solve"], max_abs_err=errs["L"],
             ms=tm["chol_ms"], plain_ms=tm["chol_plain_ms"], shape="B=1024 n=512"),
        dict(name="tri_inv", route="cuda", source=src + "chol.cuh",
             replaces="medgp_tpu/ops/pallas_chol.py:365",
             launches=counters["tri_inv"], max_abs_err=errs["Linv"],
             ms=tm["tri_ms"], plain_ms=tm["tri_plain_ms"], shape="B=1024 n=512"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
