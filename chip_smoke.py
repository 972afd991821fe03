#!/usr/bin/env python3
"""End-to-end check of the PyTorch port (medgp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. require a CUDA device and print `nvidia-smi`'s name and power limit;
  2. build the hand-written CUDA kernels from medgp_tpu_torch/csrc with nvcc
     (one nvcc per source, started together);
  3. hold each kernel (K1 gram, K3 chol_solve, K5 tri_inv, K4 qmat, K2 the
     gram backward) against its plain PyTorch twin on the card at canonical
     width (LMC-SM Q=5, D=24, R=8), and K1 and K2 also at D=48, including a
     non-SPD system and the jitter-retry loop, K1 at B=32 n=128..512 and
     the main path's other shapes (B=1, 29 and 464 at n=512, B=6 at n=128,
     B=2 at n=2048, ragged n=200, D=64), K3 and K5 from n=128 to n=4096, K4
     at n=128 to 2048; time kernel, twin and, where one exists, the one
     PyTorch call for the same function, with CUDA events (K1's kernel also
     by a CUDA graph's replay, K4 also split into K5 alone and the syrk); check
     that K3 factors a matrix bitwise alike alone, inside a batch and on
     any cluster size, that K5 and K4 give a member bitwise alike alone
     and inside a batch, and (gram_symmetry_and_batch_invariance) that K1's
     output equals its transpose and a member's alone, bitwise;
  4. one canonical objective+gradient batch (B=128, n=512, bench.py's
     protocol) through the kernels against the plain path, and its
     evaluations per second; then the restart screen at one full chunk,
     one objective+gradient evaluation at a full train bucket and one
     test-stage chunk, as utils/hbm.py sizes them at n=512, each with its
     peak device memory against the free memory its budget was taken from;
  5. drive the port's CLI on a 64-patient synthetic cohort: `generate`,
     `test` (mean_wo_update), `train` (budgets cut, see TRAIN_OPT), `test
     --mode mean_w_update`; each run with the launch counters set to 0
     just before and read just after, so every kernel of each path must
     have launched, and its peak device memory read; check every
     patient's outputs, train a second time
     (the thetas must repeat bitwise), and re-run one bucket of each test
     mode through the twins (and the first in float64);
  6. print one JSON line with the kernels' numbers, then the result line.
It imports nothing of JAX. Working files go to .chip_smoke/ beside it.
"""

from __future__ import annotations

import contextlib
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
from medgp_tpu_torch.data.cohort import load_cohort, pack_patients
from medgp_tpu_torch.data.inits import default_bounds, random_inits
from medgp_tpu_torch.data.synthetic import (
    cluster_thetas, sample_cluster_params, sample_cohort,
    write_reference_format_cohort,
)
from medgp_tpu_torch.infer.map_train import screen_inits
from medgp_tpu_torch.infer.online import online_impute, unique_times
from medgp_tpu_torch.models.gp import PatientData, objective_and_grad
from medgp_tpu_torch.models.params import LMCSMSpec, theta_from_numpy
from medgp_tpu_torch.models.priors import hier_gamma_prior
from medgp_tpu_torch.ops import cuda_build, cuda_chol, cuda_gram
from medgp_tpu_torch.ops.nlml import jittered_chol_solve
from medgp_tpu_torch.parallel.runner import MAX_BATCH, _test_prior, train_cohort
from medgp_tpu_torch.utils import hbm

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
# K4: relative to max |out|, the bound of alpha and L^{-1} (1e-4): the
#     kernel inverts L by 32-wide blocks and sums the product in tiles.
K4_REL = 1e-4
# K2 and the objective's gradient: the Pallas gram VJP's bound
#     (tests/test_pallas_gram.py:83), relative to the gradient's scale;
#     the objective's value 1e-4 relative (tests/test_pallas_chol.py:134).
GRAD_TOL = 2e-3
VALUE_REL = 1e-4

# The train stage of the smoke, cut to run in seconds: 16 restarts (of
# 1,000) and top_iteration_num 2 (of 40), i.e. two varEM warm rounds of 100
# SCG evaluations each; the rest is examples/opt_prior2.json.
TRAIN_OPT = dict(
    random_init_num=16, random_seed=718, top_iteration_num=2,
    iteration_num_per_update=30, online_learn_rate=1e-5, online_momentum=0.9,
)

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense rates): fp32
# outside the tensor cores, and device memory. bound_ms is the larger of the two
# times for the function's operations and bytes (each input read once,
# each output written once), counted from the inputs' shapes.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Operations per (entry, component) of the gram and its backward, as the
# kernels' formulas spell them out (csrc/gram.cuh): the forward's distance,
# its square, the exponent, exp, the rank-2 cosine (3), the coefficient
# product and the sum; the backward's about twice that (both partials).
# K is symmetric, so the forward's count takes each distinct entry once
# (n (n + 1) / 2 per matrix); the backward reads every entry of dK.
GRAM_OPS = 9
GRAM_BWD_OPS = 20
# The special-function units beside the fp32 rate (Hopper architecture
# white paper: 16 results per SM and clock; 132 SMs at the H100 SXM's
# 1.98 GHz boost clock): K1's exponentials, one per distinct entry and
# component, are printed as a second term beside its bound (text only).
PEAK_SFU = 132 * 16 * 1.98e9

# Launch counters of the five kernels' wrappers.
KERNELS = {
    "gram_lmcsm": cuda_gram.gram_lmcsm_fused,
    "gram_lmcsm_bwd": cuda_gram.gram_lmcsm_bwd,
    "chol_solve": cuda_chol.chol_solve,
    "qmat": cuda_chol.qmat,
    "tri_inv": cuda_chol.tri_inv,
}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bound(flops, nbytes):
    """(bound_ms, bound_by): the least time for `flops` fp32 operations
    and `nbytes` of device-memory traffic on the card's published peaks."""
    t_ops, t_bytes = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# Each kernel's wrapper and its plain twin, by the module attribute that the
# port's modules call.
TWINS = (
    (cuda_gram, "gram_lmcsm_fused", cuda_gram.gram_lmcsm_plain),
    (cuda_gram, "gram_lmcsm_bwd", cuda_gram.gram_lmcsm_bwd_plain),
    (cuda_chol, "chol_solve", cuda_chol.chol_solve_plain),
    (cuda_chol, "qmat", cuda_chol.qmat_plain),
    (cuda_chol, "tri_inv", cuda_chol.tri_inv_plain),
)


@contextlib.contextmanager
def twins():
    """Run a path of the port through the kernels' plain twins on the card:
    each wrapper's module attribute names its twin for the duration. No
    launch counter may move meanwhile, which shows that nothing reached a
    kernel past the swap."""
    before = read_launches()
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in TWINS]
    for mod, name, twin in TWINS:
        setattr(mod, name, twin)
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    check(read_launches() == before, "a kernel launched inside twins()")


def reset_launches():
    for fn in KERNELS.values():
        fn.launches = 0


def read_launches():
    return {name: fn.launches for name, fn in KERNELS.items()}


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


def graph_ms(fn, reps):
    """Mean milliseconds per call of the device's work alone: `reps` calls
    captured in one CUDA graph (after two warm-up calls on the capture
    stream), replayed once to warm up, then three times between CUDA
    events. The Python wrapper's own time per call, which cuda_ms adds
    where the kernel is shorter, is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def gram_inputs(rng, dev, Bt, n, D=D):
    """K1's inputs for Bt patients of n padded observations (between n/2 + 1
    and n real ones, over 7 days) from one cluster's hypers: [t, meta, B,
    mu, v] and the mask, on `dev`."""
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
    return args, torch.as_tensor(mask, device=dev)


def compare_gram(rng, dev, Bt, n, masked, D=D):
    args, mask = gram_inputs(rng, dev, Bt, n, D)
    m = mask if masked else None
    K = cuda_gram.gram_lmcsm_fused(*args, mask=m)
    Kp = cuda_gram.gram_lmcsm_plain(*args, mask=m)
    torch.cuda.synchronize()
    err = float((K - Kp).abs().max())
    scale = float(Kp.abs().max())
    check(bool(torch.isfinite(K).all()), f"K1 n={n}: non-finite output")
    check(err <= K1_REL * scale,
          f"K1 n={n} masked={masked}: max abs err {err} > {K1_REL} * {scale}")
    reps = 20 if Bt * n * n <= 2**24 else 5
    ms = cuda_ms(lambda: cuda_gram.gram_lmcsm_fused(*args, mask=m), reps)
    kernel_ms = graph_ms(lambda: cuda_gram.gram_lmcsm_fused(*args, mask=m), reps)
    plain_ms = cuda_ms(lambda: cuda_gram.gram_lmcsm_plain(*args, mask=m), 5)
    entries = Bt * n * (n + 1) // 2  # distinct entries of the symmetric K
    bound_ms, bound_by = bound(
        GRAM_OPS * entries * Q,
        4 * Bt * n * n + 4 * Bt * n * (3 if masked else 2) + 4 * Bt * Q * (D * D + 2),
    )
    sfu_ms = 1e3 * entries * Q / PEAK_SFU
    plan = cuda_gram.gram_plan(Bt, n)
    print(f"K1 gram B={Bt} n={n} D={D} masked={masked}: max_abs_err={err:.3e} "
          f"(tol {K1_REL:g} x max|K| = {K1_REL * scale:.3e}) "
          f"kernel {ms:.4f} ms a call through the wrapper ({kernel_ms:.4f} ms by graph "
          f"replay), twin {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; exponentials on the SFUs {sfu_ms:.4f} ms); plan (tile, "
          f"items_per_cta, ctas) {plan}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None, graph_ms=kernel_ms)


def gram_symmetry_and_batch_invariance(dev):
    """K1's output equals its transpose bitwise, masked and not, even where
    B_q is not bitwise symmetric (here its upper entries are moved one ulp),
    and members 0 and 2 computed alone equal their rows in batches of 32
    and 464 (n = 512), bitwise."""
    rng = np.random.default_rng(SEED + 1)
    for Bt in (32, 464):
        args, mask = gram_inputs(rng, dev, Bt, 512)
        Bu = torch.triu(torch.ones(D, D, dtype=torch.bool, device=dev), 1)
        args[2] = torch.where(Bu, torch.nextafter(args[2], torch.full_like(args[2], 1e30)),
                              args[2]).contiguous()
        check(not torch.equal(args[2], args[2].mT), "B_q stayed bitwise symmetric")
        for m in (None, mask):
            K = cuda_gram.gram_lmcsm_fused(*args, mask=m)
            check(torch.equal(K, K.mT),
                  f"K1 B={Bt} masked={m is not None}: K differs from its transpose")
            for i in (0, 2):
                alone = cuda_gram.gram_lmcsm_fused(
                    *(a[i:i + 1].contiguous() for a in args),
                    mask=None if m is None else m[i:i + 1].contiguous())
                check(torch.equal(alone[0], K[i]),
                      f"K1 B={Bt} masked={m is not None}: member {i} alone differs "
                      f"from its row in the batch")
            del K
        torch.cuda.synchronize()
        print(f"K1 symmetry and batch invariance B={Bt} n=512: K equals K^T bitwise "
              f"(masked and not, B_q not symmetric); members 0 and 2 bitwise equal "
              f"alone (plan {cuda_gram.gram_plan(1, 512)}) and in the batch (plan "
              f"{cuda_gram.gram_plan(Bt, 512)})")
        del args, mask
        torch.cuda.empty_cache()


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
    with twins():
        Lq, aq, _, okq, mq = jittered_chol_solve(K, y, noise, 10)
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


def chol_batch_invariance(gen, dev, Bt, n):
    """K3 factors a matrix bitwise alike alone (B=1), as a row of a batch of
    Bt, and on every cluster size up to the limit: L, alpha and linvd of
    members 0 and 2 (SPD) must be equal, not close. Returns the cluster
    sizes compared."""
    K, noise, y = spd_batch(gen, dev, Bt, n)
    batch = cuda_chol.chol_solve(K, noise, y)
    sizes = {"batch": cuda_chol.chol_cluster_size(Bt, n),
             "alone": cuda_chol.chol_cluster_size(1, n)}
    for m in (0, 2):
        alone = [cuda_chol.chol_solve(K[m:m + 1], noise[m:m + 1], y[m:m + 1])]
        c = 1
        while c <= min(cuda_chol.CLUSTER_MAX, n // cuda_chol.BLOCK):
            alone.append(cuda_chol.chol_solve_cluster(
                K[m:m + 1], noise[m:m + 1], y[m:m + 1], c))
            c *= 2
        torch.cuda.synchronize()
        for run in alone:
            for name, got, want in zip(("L", "alpha", "linvd"), run, batch):
                check(torch.equal(got[0], want[m]),
                      f"K3 n={n}: member {m}'s {name} alone differs from its "
                      f"row in a batch of {Bt}")
    sizes["compared"] = [2**k for k in range(len(alone) - 1)]
    print(f"K3 batch invariance n={n}: members 0 and 2 bitwise equal alone "
          f"(cluster {sizes['alone']}), in a batch of {Bt} (cluster "
          f"{sizes['batch']}) and on clusters {sizes['compared']}")
    return sizes


def chol_library(K, noise, y):
    """The PyTorch calls for K3's function: factor, then solve."""
    L, _ = torch.linalg.cholesky_ex(K + torch.diag_embed(noise))
    return L, torch.cholesky_solve(y[..., None], L)


def time_chol(K, noise, y, L, linvd, reps):
    Bt, n, _ = K.shape
    eye = torch.eye(n, device=K.device)
    chol_bound = bound(Bt * (n**3 / 3 + 4 * n * n), 4 * Bt * (2 * n * n + 4 * n + 32 * n))
    tri_bound = bound(Bt * n**3 / 3, 4 * Bt * (2 * n * n + 32 * n))
    return dict(
        chol_ms=cuda_ms(lambda: cuda_chol.chol_solve(K, noise, y), reps),
        chol_plain_ms=cuda_ms(lambda: cuda_chol.chol_solve_plain(K, noise, y), reps),
        chol_library_ms=cuda_ms(lambda: chol_library(K, noise, y), reps),
        chol_bound_ms=chol_bound[0], chol_bound_by=chol_bound[1],
        tri_ms=cuda_ms(lambda: cuda_chol.tri_inv(L, linvd), reps),
        tri_plain_ms=cuda_ms(lambda: cuda_chol.tri_inv_plain(L, linvd), reps),
        tri_library_ms=cuda_ms(
            lambda: torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False),
            reps),
        tri_bound_ms=tri_bound[0], tri_bound_by=tri_bound[1],
    )


def compare_qmat(gen, dev, Bt, n):
    """K4 against its twin on a factor from K3, at training's shapes."""
    A = torch.randn((Bt, n, n), generator=gen, device=dev)
    K = A @ A.mT / n + 0.5 * torch.eye(n, device=dev)
    del A
    noise = torch.full((Bt, n), 0.1, device=dev)
    y = torch.randn((Bt, n), generator=gen, device=dev)
    L, alpha, linvd = cuda_chol.chol_solve(K, noise, y)
    del K
    coef = 0.5 * torch.rand(Bt, generator=gen, device=dev) + 0.25
    out = cuda_chol.qmat(L, linvd, alpha, coef)
    want = cuda_chol.qmat_plain(L, linvd, alpha, coef)
    torch.cuda.synchronize()
    err = float((out - want).abs().max())
    scale = float(want.abs().max())
    check(bool(torch.isfinite(out).all()), f"K4 n={n}: non-finite output")
    check(torch.equal(out, out.mT), f"K4 n={n}: output not symmetric")
    check(err <= K4_REL * scale, f"K4 B={Bt} n={n}: max abs err {err} > "
          f"{K4_REL} * {scale}")
    del out, want

    def library():
        Kinv = torch.cholesky_inverse(L)
        return coef[:, None, None] * (Kinv - alpha[:, :, None] * alpha[:, None, :])

    reps = 5 if Bt <= 128 else 2
    bound_ms, bound_by = bound(Bt * 2 * n**3 / 3, 4 * Bt * (2 * n * n + 33 * n + 1))
    res = dict(
        max_abs_err=err,
        ms=cuda_ms(lambda: cuda_chol.qmat(L, linvd, alpha, coef), reps),
        plain_ms=cuda_ms(lambda: cuda_chol.qmat_plain(L, linvd, alpha, coef), reps),
        library_ms=cuda_ms(library, reps),
        bound_ms=bound_ms, bound_by=bound_by,
        # K4's first launches are K5's: K5 alone on the same L, and the rest
        tri_inv_ms=cuda_ms(lambda: cuda_chol.tri_inv(L, linvd), reps),
    )
    res["syrk_ms"] = res["ms"] - res["tri_inv_ms"]
    print(f"K4 qmat B={Bt} n={n}: max_abs_err={err:.3e} (tol {K4_REL:g} x "
          f"max|out| = {K4_REL * scale:.3e}); kernel {res['ms']:.3f} ms (K5 alone "
          f"{res['tri_inv_ms']:.3f} ms, the syrk the rest, {res['syrk_ms']:.3f} ms), "
          f"twin {res['plain_ms']:.3f} ms, cholesky_inverse + rank-1 "
          f"{res['library_ms']:.3f} ms, bound {bound_ms:.3f} ms ({bound_by})")
    return res


def tri_qmat_batch_invariance(gen, dev):
    """K5 and K4 compute each member alone as in a batch: X of members 0
    and 2 (SPD) at B=64 and B=1024, n=512, and at B=8, n=2048, and K4's
    output at B=128, n=512, must be equal, not close."""
    for Bt, n in ((64, 512), (1024, 512), (8, 2048)):
        K, noise, y = spd_batch(gen, dev, Bt, n)
        L, _, linvd = cuda_chol.chol_solve(K, noise, y)
        del K
        X = cuda_chol.tri_inv(L, linvd)
        for m in (0, 2):
            alone = cuda_chol.tri_inv(L[m:m + 1].contiguous(), linvd[m:m + 1].contiguous())
            check(torch.equal(alone[0], X[m]),
                  f"K5 B={Bt} n={n}: member {m}'s L^-1 alone differs from its row "
                  f"in the batch")
        del L, linvd, X
        torch.cuda.empty_cache()
        print(f"K5 batch invariance B={Bt} n={n}: members 0 and 2 bitwise equal "
              f"alone and in the batch")
    Bt, n = 128, 512
    K, noise, y = spd_batch(gen, dev, Bt, n)
    L, alpha, linvd = cuda_chol.chol_solve(K, noise, y)
    coef = 0.5 * torch.rand(Bt, generator=gen, device=dev) + 0.25
    out = cuda_chol.qmat(L, linvd, alpha, coef)
    for m in (0, 2):
        alone = cuda_chol.qmat(L[m:m + 1].contiguous(), linvd[m:m + 1].contiguous(),
                               alpha[m:m + 1].contiguous(), coef[m:m + 1].contiguous())
        check(torch.equal(alone[0], out[m]),
              f"K4 B={Bt} n={n}: member {m}'s output alone differs from its row "
              f"in the batch")
    print(f"K4 batch invariance B={Bt} n={n}: members 0 and 2 bitwise equal alone "
          f"and in the batch")


def compare_gram_bwd(rng, dev, Bt, n, masked, D=D):
    """K2 against its twin at width D (canonical 24), on a non-symmetric dK."""
    args, mask = gram_inputs(rng, dev, Bt, n, D)
    dK = torch.randn((Bt, n, n), generator=torch.Generator(device=dev).manual_seed(n),
                     device=dev)
    m = mask if masked else None
    got = cuda_gram.gram_lmcsm_bwd(dK, *args, mask=m)
    want = cuda_gram.gram_lmcsm_bwd_plain(dK, *args, mask=m)
    again = cuda_gram.gram_lmcsm_bwd(dK, *args, mask=m)
    torch.cuda.synchronize()
    errs = {}
    for name, g, w in zip(("dB", "dmu", "dv"), got, want):
        scale = float(w.abs().max())
        errs[name] = float((g - w).abs().max())
        check(bool(torch.isfinite(g).all()), f"K2 {name}: non-finite")
        check(errs[name] <= GRAD_TOL * scale,
              f"K2 B={Bt} n={n} masked={masked} {name}: max abs err "
              f"{errs[name]} > {GRAD_TOL} * {scale}")
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K2: two launches on the same inputs differ (not deterministic)")
    bound_ms, bound_by = bound(  # dK, t, meta [, mask] and B, mu, v in; dB, dmu, dv out
        GRAM_BWD_OPS * Bt * n * n * Q,
        4 * Bt * n * n + 4 * Bt * n * (3 if masked else 2) + 2 * 4 * Bt * Q * (D * D + 2),
    )
    res = dict(
        max_abs_err=max(errs.values()),
        ms=cuda_ms(lambda: cuda_gram.gram_lmcsm_bwd(dK, *args, mask=m), 10),
        plain_ms=cuda_ms(lambda: cuda_gram.gram_lmcsm_bwd_plain(dK, *args, mask=m), 3),
        library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
    )
    print(f"K2 gram_bwd B={Bt} n={n} D={D} masked={masked}: max abs err dB "
          f"{errs['dB']:.3e}, dmu {errs['dmu']:.3e}, dv {errs['dv']:.3e} (tol "
          f"{GRAD_TOL:g} x each scale), deterministic; kernel {res['ms']:.3f} ms, "
          f"twin {res['plain_ms']:.3f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return res


def objective_batch(dev, batch=128, n=512, steps=12):
    """bench.py's objective+gradient protocol (hier-gamma prior, random
    data, 12 chained steps theta -= 1e-6 grad) through the kernels and
    through the plain path; returns evaluations per second of each."""
    spec = LMCSMSpec(Q, D, R)
    data = random_patients(dev, batch, n, 1)
    th = random_thetas(dev, spec, batch, 1)
    f = objective_and_grad(spec, data, hier_gamma_prior(spec, beta_lam=0.01, device=dev))

    def f_plain(x):
        with twins():
            return f(x)

    v, g, ok = f(th)
    v2, g2, _ = f(th)
    vp, gp, okp = f_plain(th)
    torch.cuda.synchronize()
    check(bool(ok.all()) and bool(okp.all()), "objective batch: a failed evaluation")
    # every kernel and the glue sum in a fixed order: SCG trajectories repeat
    check(torch.equal(v, v2) and torch.equal(g, g2),
          "objective batch: two evaluations of the same thetas differ")
    v_err = float(((v - vp) / vp).abs().max())
    g_err = float((g - gp).abs().max())
    g_scale = float(gp.abs().max())
    check(v_err <= VALUE_REL, f"objective batch: value rel err {v_err} > {VALUE_REL}")
    check(g_err <= GRAD_TOL * g_scale,
          f"objective batch: grad err {g_err} > {GRAD_TOL} * {g_scale}")

    def chained(f):
        x = th
        for _ in range(steps):
            _, gg, _ = f(x)
            x = x - 1e-6 * gg
        return x

    rates = {}
    for name, fn in (("kernels", f), ("plain", f_plain), ("kernels2", f)):
        chained(fn)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = chained(fn)
        check(bool(torch.isfinite(x).all()), "objective batch went non-finite")
        torch.cuda.synchronize()
        rates[name] = batch * steps / (time.perf_counter() - t0)
    print(f"objective+gradient B={batch} n={n}: bitwise equal on repeat; kernels "
          f"vs plain value rel err {v_err:.3e} (tol {VALUE_REL:g}), grad max abs "
          f"err {g_err:.3e} (tol "
          f"{GRAD_TOL:g} x {g_scale:.3e}); {rates['kernels']:.1f} and "
          f"{rates['kernels2']:.1f} evals/s through the kernels, "
          f"{rates['plain']:.1f} through the plain path")
    return rates



def random_patients(dev, batch, n, seed):
    """bench.py's random padded-free batch: sorted times over 7 days,
    uniform outputs, normal values."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 168.0, size=(batch, n)), 1).astype(np.float32)
    meta = rng.integers(0, D, size=(batch, n)).astype(np.int32)
    y = rng.normal(size=(batch, n)).astype(np.float32)
    return PatientData(
        t=torch.as_tensor(t, device=dev), y=torch.as_tensor(y, device=dev),
        meta=torch.as_tensor(meta, device=dev),
        mask=torch.ones((batch, n), device=dev),
    )


def random_thetas(dev, spec, batch, seed):
    """bench.py's thetas: normal * 0.1, noise std 0.3."""
    th = np.random.default_rng(seed).normal(size=(batch, spec.n_hyp)) * 0.1
    th[:, :D] = np.log(0.3)
    return torch.as_tensor(th.astype(np.float32), device=dev)


def peak_bytes(fn):
    """(free bytes before, peak bytes allocated above the start) of fn()."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    free0 = torch.cuda.mem_get_info(0)[0]
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return free0, torch.cuda.max_memory_allocated() - base


def memory_budgets(dev, n=512, restarts=16):
    """Fill three budgets of utils/hbm.py once each at n=512 and read the
    peak of device memory: one restart-screen chunk (`screen_inits`, with
    more (patient, restart) systems than `screen_chunk_systems` allows),
    one train bucket of `train_batch_cap` patients (one objective+gradient
    evaluation under the hier-gamma prior) and one test-stage chunk
    (`online_impute` without updates over more (patient, timestamp) pairs
    than `test_chunk_pairs` allows). Each must fit in the free memory its
    budget was derived from; the bytes per system are printed beside the
    derivation's count. Each budget is taken with the allocator's cache
    emptied, as a fresh process would take it."""
    spec = LMCSMSpec(Q, D, R)
    out = {}
    torch.cuda.empty_cache()
    chunk = hbm.screen_chunk_systems(n, dev)
    data = random_patients(dev, chunk // restarts + 1, n, 2)
    inits = random_inits(SEED, spec, default_bounds(spec), restarts).to(dev)
    free0, peak = peak_bytes(lambda: screen_inits(spec, data, inits))
    out["screen"] = (chunk, free0, peak, hbm.SCREEN_BUFFERS_PER_SYSTEM, hbm.SCREEN_SHARE)
    del data
    torch.cuda.empty_cache()
    cap = hbm.train_batch_cap(n, dev)
    data = random_patients(dev, cap, n, 3)
    th = random_thetas(dev, spec, cap, 3)
    f = objective_and_grad(spec, data, hier_gamma_prior(spec, beta_lam=0.01, device=dev))
    free0, peak = peak_bytes(lambda: f(th))
    out["train"] = (cap, free0, peak, hbm.TRAIN_BUFFERS_PER_PATIENT, hbm.TRAIN_SHARE)
    del data, th, f
    torch.cuda.empty_cache()
    pairs = hbm.test_chunk_pairs(n, dev)
    data = random_patients(dev, 2 * pairs // n + 1, n, 4)  # n distinct times each
    theta = random_thetas(dev, spec, 1, 4)[0]
    free0, peak = peak_bytes(lambda: online_impute(
        spec, theta, data, data.t, torch.ones_like(data.mask, dtype=torch.bool)))
    out["test"] = (pairs, free0, peak, hbm.TEST_BUFFERS_PER_PAIR, hbm.TEST_SHARE)
    del data
    torch.cuda.empty_cache()
    for name, (systems, free0, peak, buffers, share) in out.items():
        per = peak / systems / (4 * n * n)
        print(f"memory {name}: {systems} systems at n={n}, peak {peak / 2**30:.2f} "
              f"GiB of {free0 / 2**30:.2f} GiB free ({peak / free0:.3f}; budget "
              f"1/{share}); {per:.2f} (n, n) float32 arrays per system, derived "
              f"{buffers}")
        check(peak < free0, f"memory {name}: peak {peak} exceeds free {free0}")
    return out


def stage_cohort():
    """Stage the 64-patient cohort and `generate` the experiment through the
    CLI, with the mode kernel (cluster 0's ground truth) for "all" and
    every fold; returns (cfg_path, cfg, recs, theta)."""
    spec = LMCSMSpec(Q, D, R)
    feature_config = os.path.join(ROOT, "examples", "feature_all.json")
    with open(feature_config) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    check(len(features) == D, f"{feature_config}: expected {D} features")
    recs = sample_cohort(SEED, spec, 64, n_clusters=4, n_obs_range=(100, 400))
    write_reference_format_cohort(os.path.join(WORK, "data", "synth"), recs, features)
    print(f"staged {len(recs)} patients ({sum(r.n_obs for r in recs)} observations)")
    opt_path = os.path.join(WORK, "opt_smoke.json")
    with open(opt_path, "w") as f:
        json.dump(TRAIN_OPT, f)
    cli([
        "generate", "--data-root", os.path.join(WORK, "data"),
        "--exp-root", os.path.join(WORK, "exp"), "--cohort", "synth",
        "--feature-config", feature_config, "--opt-config", opt_path,
        "--kernel", "LMC-SM", "--prior", "hier-gamma", "--Q", str(Q),
        "--R", str(R), "--eta", "0.01", "--beta-lam", "0.01",
        "--cv-fold-num", "10", "--exp-prefix", "smoke",
    ])
    cfg_path = os.path.join(
        WORK, "exp", "smoke_k7_q5_r8_p2_e0.01", "config", "exp_setup.json"
    )
    cfg = ExperimentConfig.from_json(cfg_path)
    theta = cluster_thetas(SEED, spec, 4)[0]
    for fold in range(-1, cfg.cv_fold_num):
        formats.write_mode_kernel(cfg.exp_kernel_dir, fold, "gmm", theta, Q)
    return cfg_path, cfg, recs, theta


def run_path(name, argv, needs):
    """One main-path run through the CLI with the launch counters set to 0
    just before and read just after; every kernel in `needs` must have
    launched. Returns (seconds, counts)."""
    reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cli(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_launches()
    print(f"{name}: {seconds:.2f} s; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches {counts}")
    for k in needs:
        check(counts[k] > 0, f"{name} never launched {k}")
    return seconds, counts


def check_test_outputs(cfg, recs, mode):
    outputs = {}
    for r in recs:
        paths = formats.test_paths(cfg.exp_test_dir, mode, r.pan)
        missing = [k for k, p in paths.items() if not os.path.exists(p)]
        check(not missing, f"{r.pan}: missing {mode} outputs {missing}")
        flag, res = formats.read_test_result(cfg.exp_test_dir, mode, r.pan)
        check(flag == 1, f"{r.pan}: {mode} flag {flag}")
        for k in ("pred", "error", "var", "ci", "feature", "etime"):
            check(len(res[k]) == r.n_obs, f"{r.pan}: {mode} {k} has "
                  f"{len(res[k])} entries for {r.n_obs} observations")
        check(bool(np.all(np.isfinite(res["pred"]))), f"{r.pan}: non-finite pred")
        check(bool(np.all(np.isfinite(res["var"]))), f"{r.pan}: non-finite var")
        outputs[r.pan] = res
    n_pred = sum(len(o["pred"]) for o in outputs.values())
    err = np.concatenate([o["error"] for o in outputs.values()])
    ci = np.concatenate([o["ci"] for o in outputs.values()])
    print(f"test stage ({mode}): {len(outputs)} patients, {n_pred} predictions; "
          f"MAE {np.mean(np.abs(err)):.4f}, CI coverage {100 * np.mean(ci):.2f}%")
    return n_pred


def check_train_outputs(cfg, recs):
    spec = LMCSMSpec(Q, D, R)
    n_var = 2 * Q * (D * R + R)
    trained = 0
    for r in recs:
        p = formats.train_paths(cfg.exp_train_dir, r.pan)
        for k in ("flag", "num", "init"):
            check(os.path.exists(p[k]), f"{r.pan}: missing {os.path.basename(p[k])}")
        check(int(formats.read_int_txt(p["num"])[0]) == r.n_obs, f"{r.pan}: train_num")
        init = formats.read_double_bin(p["init"])
        check(init.shape == (spec.n_hyp,) and bool(np.all(np.isfinite(init))),
              f"{r.pan}: train_init_hyp")
        if int(formats.read_int_txt(p["flag"])[0]):
            trained += 1
            theta = formats.read_double_bin(p["hyp"])
            var = formats.read_double_bin(p["var_hyp"])
            check(theta.shape == (spec.n_hyp,) and bool(np.all(np.isfinite(theta))),
                  f"{r.pan}: train_hyp")
            check(var.shape == (n_var,) and bool(np.all(np.isfinite(var))),
                  f"{r.pan}: train_var_hyp")
    print(f"train stage: {trained}/{len(recs)} patients trained, every written "
          f"theta finite")
    check(trained >= 0.9 * len(recs), f"only {trained}/{len(recs)} patients trained")
    return trained


def retrain_repeats(cfg, dev):
    """Train the cohort again in this process: every kernel and the glue
    sum in a fixed order, so the trained thetas equal the files bitwise."""
    again = train_cohort(
        cfg, load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list),
        write=False, device=dev,
    )
    for pan, res in again.items():
        p = formats.train_paths(cfg.exp_train_dir, pan)
        check(res["flag"] == bool(formats.read_int_txt(p["flag"])[0]),
              f"{pan}: a second train run flags it differently")
        if res["flag"]:
            check(np.array_equal(res["theta"], formats.read_double_bin(p["hyp"])),
                  f"{pan}: a second train run gives another theta")
    print(f"train stage: a second run repeats all {len(again)} thetas bitwise")


def bucket_of(dev, recs, which):
    b = which(pack_patients(recs, max_batch=MAX_BATCH, device=dev))
    ut = np.zeros((len(b), b.n_max), np.float32)
    uv = np.zeros((len(b), b.n_max), bool)
    for i in range(len(b)):
        ut[i], uv[i] = unique_times(b.t[i], b.mask[i], pad_to=b.n_max)
    return b, ut, uv


def compare_bucket(label, ker, twin):
    valid = ker.valid
    check(torch.equal(valid, twin.valid), f"{label}: valid masks differ")
    d_pred = float((ker.pred - twin.pred)[valid].abs().max())
    d_var = float(((ker.var - twin.var) / twin.var)[valid].abs().max())
    flips = float((ker.ci != twin.ci)[valid].float().mean())
    check(d_pred <= PRED_TOL, f"{label}: predictions differ by {d_pred}")
    check(d_var <= PRED_TOL, f"{label}: variances differ by {d_var} (relative)")
    check(flips <= CI_FLIP_MAX, f"{label}: {flips} of the CI flags differ")
    return d_pred, d_var, flips, int(valid.sum())


def recheck_bucket(cfg, recs, theta, dev):
    """One bucket of the test stage: kernels vs twins on the card, both vs
    a float64 run of the twins."""
    spec = LMCSMSpec(Q, D, R)
    fold0 = [r for r, f in zip(recs, cfg.cv_assign()) if f == 0]
    b, ut, uv = bucket_of(dev, fold0, lambda bs: max(bs, key=lambda x: x.n_max))

    def run(dtype):
        data = PatientData(
            t=torch.as_tensor(b.t, device=dev, dtype=dtype),
            y=torch.as_tensor(b.y, device=dev, dtype=dtype),
            meta=torch.as_tensor(b.meta, device=dev),
            mask=torch.as_tensor(b.mask, device=dev, dtype=dtype),
        )
        th = torch.as_tensor(np.asarray(theta, np.float32), device=dev).to(dtype)
        return online_impute(
            spec, th, data, torch.as_tensor(ut, device=dev, dtype=dtype),
            torch.as_tensor(uv, device=dev),
        )

    ker = run(torch.float32)
    with twins():
        twin = run(torch.float32)
        gold = run(torch.float64)
    d_pred, d_var, flips, n = compare_bucket("bucket", ker, twin)
    g_ker = float((ker.pred - gold.pred.float())[ker.valid].abs().max())
    g_twin = float((twin.pred - gold.pred.float())[ker.valid].abs().max())
    print(f"bucket n_max={b.n_max} B={len(b)} ({n} predictions): kernels vs "
          f"twins max |d pred| {d_pred:.3e} (tol {PRED_TOL:g}), max rel d var "
          f"{d_var:.3e}, CI flips {flips:.2e} (max {CI_FLIP_MAX:g}); vs float64 "
          f"twins: kernels {g_ker:.3e}, float32 twins {g_twin:.3e}")


def recheck_update_bucket(cfg, recs, theta, dev):
    """One bucket of mean_w_update (fold 0's kernel, the CLI run's
    setting): kernels vs twins on the card."""
    spec = LMCSMSpec(Q, D, R)
    b, ut, uv = bucket_of(dev, recs, lambda bs: bs[0])
    th = theta_from_numpy(spec, theta, dev)
    prior = _test_prior(spec, theta, dev)
    data = PatientData(*(torch.as_tensor(x, device=dev) for x in (b.t, b.y, b.meta, b.mask)))

    def run():
        return online_impute(
            spec, th, data, torch.as_tensor(ut, device=dev),
            torch.as_tensor(uv, device=dev), update=True, prior=prior,
            learn_rate=cfg.online_learn_rate, momentum=cfg.online_momentum,
        )

    ker = run()
    with twins():
        twin = run()
    d_pred, d_var, flips, n = compare_bucket("update bucket", ker, twin)
    d_theta = float((ker.theta_final - twin.theta_final).abs().max())
    moved = float((ker.theta_final - th).abs().max())
    print(f"update bucket n_max={b.n_max} B={len(b)} ({n} predictions): kernels "
          f"vs twins max |d pred| {d_pred:.3e} (tol {PRED_TOL:g}), max rel d var "
          f"{d_var:.3e}, CI flips {flips:.2e}; theta_final differs by "
          f"{d_theta:.3e} after moving {moved:.3e} from the mode")


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
    phase_s = {}
    t_phase = time.perf_counter()

    def phase_done(name):
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[name] = now - t_phase
        print(f"-- phase {name}: {phase_s[name]:.1f} s")
        t_phase = now

    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    path, build_s, log = cuda_build.build_library()
    print(f"built {os.path.relpath(path, ROOT)} from medgp_tpu_torch/csrc "
          f"with nvcc in {build_s:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "entry function" in line:
            print("  ptxas:", line.strip())
    phase_done("build")

    rng = np.random.default_rng(SEED)
    k1 = {}
    for n in (128, 256, 512):
        for masked in (False, True):
            k1[f"B=32 n={n}{' masked' if masked else ''}"] = compare_gram(
                rng, dev, 32, n, masked)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    tri_shapes = {}  # K5 at every shape timed

    def tri_row(Bt, n, tm, errs):
        tri_shapes[f"B={Bt} n={n}"] = dict(
            max_abs_err=errs["Linv"], ms=tm["tri_ms"], plain_ms=tm["tri_plain_ms"],
            library_ms=tm["tri_library_ms"], bound_ms=tm["tri_bound_ms"],
            bound_by=tm["tri_bound_by"])

    for n in (128, 256, 512, 1024):
        K, noise, y, L, linvd, errs = compare_chol(gen, dev, 64, n)
        tm = time_chol(K, noise, y, L, linvd, 5)
        tri_row(64, n, tm, errs)
        print(f"K3/K5 B=64 n={n} times: chol_solve kernel {tm['chol_ms']:.3f} ms, "
              f"twin {tm['chol_plain_ms']:.3f} ms, cholesky_ex + cholesky_solve "
              f"{tm['chol_library_ms']:.3f} ms, bound {tm['chol_bound_ms']:.3f} ms; "
              f"tri_inv kernel {tm['tri_ms']:.3f} ms, twin {tm['tri_plain_ms']:.3f} "
              f"ms, solve_triangular {tm['tri_library_ms']:.3f} ms, bound "
              f"{tm['tri_bound_ms']:.3f} ms")
        del K, noise, y, L, linvd
    # large patients' shapes: a few matrices at n = 2048 and 4096
    chol_more = {}
    for Bt, n in ((8, 2048), (4, 4096)):
        K, noise, y, L, linvd, errs = compare_chol(gen, dev, Bt, n)
        tm = time_chol(K, noise, y, L, linvd, 2)
        chol_more[f"B={Bt} n={n}"] = dict(
            ms=tm["chol_ms"], plain_ms=tm["chol_plain_ms"],
            library_ms=tm["chol_library_ms"], bound_ms=tm["chol_bound_ms"],
            tri_ms=tm["tri_ms"], tri_plain_ms=tm["tri_plain_ms"],
            tri_library_ms=tm["tri_library_ms"], tri_bound_ms=tm["tri_bound_ms"],
        )
        tri_row(Bt, n, tm, errs)
        print(f"K3/K5 B={Bt} n={n} times: chol_solve kernel {tm['chol_ms']:.3f} ms "
              f"(cluster {cuda_chol.chol_cluster_size(Bt, n)}), twin "
              f"{tm['chol_plain_ms']:.3f} ms, cholesky_ex + cholesky_solve "
              f"{tm['chol_library_ms']:.3f} ms, bound {tm['chol_bound_ms']:.3f} ms "
              f"({tm['chol_bound_by']}); tri_inv kernel {tm['tri_ms']:.3f} ms, twin "
              f"{tm['tri_plain_ms']:.3f} ms, solve_triangular "
              f"{tm['tri_library_ms']:.3f} ms, bound {tm['tri_bound_ms']:.3f} ms")
        del K, noise, y, L, linvd
        torch.cuda.empty_cache()
    for Bt, n in ((64, 512), (8, 2048)):
        chol_batch_invariance(gen, dev, Bt, n)
    torch.cuda.empty_cache()
    # the test stage's shape: thousands of (patient, timestamp) systems at n=512
    K, noise, y, L, linvd, errs = compare_chol(gen, dev, 1024, 512)
    tm = time_chol(K, noise, y, L, linvd, 3)
    tri_row(1024, 512, tm, errs)
    print(f"K3/K5 B=1024 n=512 times: chol_solve kernel {tm['chol_ms']:.3f} ms, "
          f"twin {tm['chol_plain_ms']:.3f} ms, cholesky_ex + cholesky_solve "
          f"{tm['chol_library_ms']:.3f} ms, bound {tm['chol_bound_ms']:.3f} ms "
          f"({tm['chol_bound_by']}); tri_inv kernel {tm['tri_ms']:.3f} ms, twin "
          f"{tm['tri_plain_ms']:.3f} ms, solve_triangular {tm['tri_library_ms']:.3f} "
          f"ms, bound {tm['tri_bound_ms']:.3f} ms ({tm['tri_bound_by']})")
    del K, noise, y, L, linvd
    torch.cuda.empty_cache()
    k4 = {(Bt, n): compare_qmat(gen, dev, Bt, n)
          for Bt, n in ((128, 512), (1024, 512), (128, 128), (128, 256), (8, 2048))}
    torch.cuda.empty_cache()
    tri_qmat_batch_invariance(gen, dev)
    torch.cuda.empty_cache()
    k2 = {}
    for Bt in (32, 128):
        for masked in (False, True):
            k2[(Bt, masked)] = compare_gram_bwd(rng, dev, Bt, 512, masked)
    torch.cuda.empty_cache()
    # past the old caps (K1: Q*D*D <= 8192 floats, K2: D <= 32)
    k1["B=32 n=512 D=48 masked"] = compare_gram(rng, dev, 32, 512, True, D=48)
    k2[(128, True, 48)] = compare_gram_bwd(rng, dev, 128, 512, True, D=48)
    k1["B=8 n=256 D=64 masked"] = compare_gram(rng, dev, 8, 256, True, D=64)
    torch.cuda.empty_cache()
    # K1 at the main path's other shapes: one patient, the n=128 and n=512
    # buckets of mean_w_update, the screen's chunk, a large patient, ragged n
    for Bt, n in ((1, 512), (6, 128), (29, 512), (464, 512), (2, 2048), (32, 200)):
        k1[f"B={Bt} n={n} masked"] = compare_gram(rng, dev, Bt, n, True)
        torch.cuda.empty_cache()
    phase_done("kernels vs twins")
    gram_symmetry_and_batch_invariance(dev)
    phase_done("gram_symmetry_and_batch_invariance")

    rates = objective_batch(dev)
    torch.cuda.empty_cache()
    phase_done("objective batch")
    memory_budgets(dev)
    phase_done("memory budgets")

    cfg_path, cfg, recs, theta = stage_cohort()
    base = ["--cfg", cfg_path, "--device", str(dev)]
    wo_s, wo = run_path(
        "test (mean_wo_update)", ["test", *base, "--alg", "gmm"],
        ("gram_lmcsm", "chol_solve", "tri_inv"),
    )
    n_pred = check_test_outputs(cfg, recs, "mean_wo_update")
    print(f"test stage (mean_wo_update): {n_pred / wo_s:.1f} predictions/s")
    recheck_bucket(cfg, recs, theta, dev)
    phase_done("test mean_wo_update")

    tr_s, tr = run_path(
        "train", ["train", *base],
        ("gram_lmcsm", "chol_solve", "qmat", "gram_lmcsm_bwd"),
    )
    check_train_outputs(cfg, recs)
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        train_recs = [json.loads(x) for x in f if '"stage": "train"' in x]
    evals = sum(r["evaluations"] for r in train_recs)
    print(f"train stage: {len(train_recs)} buckets, {evals:.0f} objective+gradient "
          f"evaluations in {tr_s:.2f} s = {evals / tr_s:.1f} evals/s, "
          f"{len(recs) / tr_s:.2f} patients/s")
    retrain_repeats(cfg, dev)
    phase_done("train")

    wu_s, wu = run_path(
        "test (mean_w_update, fold 0's kernel for every patient)",
        ["test", *base, "--alg", "gmm", "--mode", "mean_w_update", "--fold", "0"],
        tuple(KERNELS),
    )
    n_pred = check_test_outputs(cfg, recs, "mean_w_update")
    print(f"test stage (mean_w_update): {n_pred / wu_s:.1f} predictions/s")
    recheck_update_bucket(cfg, recs, theta, dev)
    phase_done("test mean_w_update")

    by_path = {
        name: {"test_wo_update": wo[name], "train": tr[name], "test_w_update": wu[name]}
        for name in KERNELS
    }
    src = "medgp_tpu_torch/csrc/"

    def row(name, source, replaces, r, shape):
        return dict(
            name=name, route="cuda", source=src + source, replaces=replaces,
            launches=sum(by_path[name].values()), max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"], shape=shape,
            launches_by_path=by_path[name],
        )

    chol_r = dict(max_abs_err=errs["L"], ms=tm["chol_ms"], plain_ms=tm["chol_plain_ms"],
                  bound_ms=tm["chol_bound_ms"], bound_by=tm["chol_bound_by"],
                  library_ms=tm["chol_library_ms"])
    kernels = [
        dict(row("gram_lmcsm", "gram.cuh", "medgp_tpu/ops/pallas_gram.py:154",
                 k1["B=32 n=512"], "B=32 n=512 Q=5 D=24"),
             d48_masked=k1["B=32 n=512 D=48 masked"], more_shapes=k1),
        dict(row("gram_lmcsm_bwd", "gram.cuh", "medgp_tpu/ops/pallas_gram.py:248",
                 k2[(128, True)], "B=128 n=512 Q=5 D=24 masked"),
             d48=k2[(128, True, 48)]),
        dict(row("chol_solve", "chol.cuh", "medgp_tpu/ops/pallas_chol.py:235",
                 chol_r, "B=1024 n=512"), more_shapes=chol_more),
        dict(row("qmat", "qmat.cuh", "medgp_tpu/ops/pallas_chol.py:479",
                 k4[(128, 512)], "B=128 n=512"),
             tri_inv_ms=k4[(128, 512)]["tri_inv_ms"], syrk_ms=k4[(128, 512)]["syrk_ms"],
             more_shapes={f"B={b} n={n}": r for (b, n), r in k4.items()}),
        dict(row("tri_inv", "chol.cuh", "medgp_tpu/ops/pallas_chol.py:365",
                 tri_shapes["B=1024 n=512"], "B=1024 n=512"), more_shapes=tri_shapes),
    ]
    print(f"phases (s): {json.dumps({k: round(v, 2) for k, v in phase_s.items()})}; "
          f"objective+gradient evals/s at B=128 n=512: {rates['kernels']:.1f}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    sys.exit(main())
