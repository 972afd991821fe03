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
     evaluations per second; the fused objective's θ prologue and gradient
     epilogue (csrc/theta.cuh) against their twins at B=128, n=512, bitwise
     alike on repeat, and timed; then the restart screen at one full chunk,
     one objective+gradient evaluation at a full train bucket and one
     test-stage chunk, as utils/hbm.py sizes them at n=512, each with its
     peak device memory against the free memory its budget was taken from;
  5. drive the port's CLI on a 64-patient synthetic cohort: `generate`,
     `test --mode mean_wo_update`, `train` (budgets cut, see TRAIN_OPT), `test
     --mode mean_w_update`; each run with the launch counters set to 0
     just before and read just after, so every kernel of each path must
     have launched, and its peak device memory read; check every
     patient's outputs, train a second time
     (the thetas must repeat bitwise), and re-run one bucket of each test
     mode through the twins (and the first in float64);
  6. the fused CLI `run` (train, kernclust of every fold with the GMM and
     the KDEs on the card, test in both modes, eval) twice, each with the
     counters set to 0 just before and read just after: at full width on
     the same 64 patients with two folds through the example script
     medgp_tpu_torch/examples/run_pipeline.sh (a process of its own whose
     launches its stand-in $PYTHON counts: `--rank exec`), then
     `kernclust --fold -1` and `eval` on its files, which must repeat its
     mode kernel and summary;
     and on tools/refbudget_run.sh's PT/INR cohort at its reduced budgets,
     trained from the JAX package's restart draws, where each test mode's
     MAE must lie within three combined standard errors of the JAX
     package's (JAX_PTINR_MAE); then on the same cohort from the port's
     own restart draws, the path users run, where each mode's MAE must lie
     within a 3-sd prediction interval of the JAX package's draw sets
     (JAX_DRAWS_PTINR_MAE);
  7. the posterior samplers on the trained cohort of phase 5, every
     (patient, chain) drawing from its own counter-based stream
     (medgp_tpu_torch/infer/streams.py): the HMC
     potential (K1, K3, K4 with K5 inside it, K2) on the n=512 bucket's
     (patient, chain) rows and one 16-step leapfrog trajectory, kernels
     against twins; the CLI `hmc` with each sampler (hmc, nuts, vi) at cut
     budgets (SAMPLER_BUDGET), each through the launch counters, every
     patient's files checked, NUTS's depth within warmup_max_depth + 1, and
     a second `hmc` run repeating the draws bitwise; after the `run`
     phases, `run --sampler hmc` at full width with two folds (the
     posterior-mean handoff logged for every trained patient, the `run`
     record's sampler_seconds); the JAX tests' Gaussian targets on the
     card; and the rates at bench.py's sampler protocol (BENCH: draws/s,
     min bulk ESS/s, ADVI steps/s, objective batches and host reads per
     transition);
  8. the large-patient path at canonical width: the row-blocked objective
     at n=4096 over 4 blocks (K3 and K5 on each diagonal block), bitwise
     alike on repeat, against the dense one of `objective_and_grad` and
     the float64 twins, with
     K3 and K5 on one diagonal block (B=1) timed beside `cholesky_ex` and
     `solve_triangular`; the CLI `train` through the example script
     train_large_patient.sh (default threshold, --restarts 64) on a cohort
     with one 16,384-observation patient, which trains by row blocks
     (one `train_large` record, its NLML below the best screen value);
     one value+gradient at n=16,384 and at n=65,536, each with its seconds
     and its peak device memory beside utils/hbm.py's rule;
  9. the multi-rank phases: mesh_world1, an NCCL group of one rank on the
     card, runs `train_cohort`, `test_cohort` (each mode as phase 5 ran
     it) and `hmc_cohort` (hmc, as phase 7's CLI `hmc`) with use_mesh=True,
     each equal bitwise to phase 5's and 7's files, the per-fold noise
     modes over NCCL within MESH_NOISE_REL of the host float64 KDE, and one
     row-sharded value+gradient at n = 16,384 over 4 blocks through the
     collective helpers, equal bitwise to the one-device blocked path;
     then two ranks sharing the one card over gloo (NCCL refuses two ranks
     on one device), each phase one `torchrun` of this script (`--rank`):
     mesh_shared_card, the CLI `run` at full width with two folds: each
     rank's recorded slice of every train bucket must be that bucket's
     rows and train on this one device to the rank's bits, rank 0's train
     files must hold them (check_rank_slices), and its mode kernels must
     equal those of the host path on the same train files but for the
     noise block (within MESH_NOISE_REL); the train path is not
     batch-invariant on the card, so the files are also compared with
     phase 6's full-width `run`, which trains whole buckets, and the
     difference printed; and large_sharded_shared_card, the row-sharded
     value+gradient of mesh_world1 over two ranks (two blocks each), its
     value within MESH_VALUE_REL and its gradient within MESH_GRAD_TOL of
     the row's scale of the one-rank result, with each rank's peak device
     memory beside utils/hbm.py's rule at world 2; and sampler_shared_card,
     the CLI `hmc` over the two ranks on phase 5's MAP files: one device
     sampling each rank's recorded slice with the same streams must give
     the rank's draws bitwise, the slices keyed by the patients' cohort
     indices, and the difference from phase 7's whole-bucket draws is
     printed (not checked: the card's reductions, ROADMAP.md §C). Each rank
     writes its launch counts to a JSON file, which the kernels line adds
     in;
 10. etl_to_run, from raw tables to a full-width `run` on the card:
     synthetic MIMIC-III tables (ETL_ADMISSIONS), the port's
     extract_cohort_from_csvs (its seconds and rows/s) held to what the
     generator worked out (the id list, every feature file byte for byte,
     the stats within 1e-12 of numpy's); the native cohort loader, which
     must build, bitwise the Python loader on that cohort (both timed);
     CLI `generate` and `run` on it at full width with two folds, every
     kernel launched and every output checked as in phase 6; K1's masked
     gram on trained patients of the n = 512 bucket against the float64
     fastkernel oracle (1e-4 relative, 1e-5 absolute); and the fold -1
     mode kernel's printed summary and plots ("matplotlib absent" where
     it is);
 11. examples: the port's example entry points on the card besides the
     two of phases 6 and 8, each a process of its own with its launches
     counted: launch_pod.py under `torchrun --standalone --nproc-per-node
     1` (`run` on 16 of the staged patients, two folds, every output
     checked) and gen_example.sh, which writes the canonical experiment
     over etl_to_run's cohort without running it (its config checked);
 12. print one JSON line with the samplers' numbers, one with the large
     patient's, one with the multi-rank phases', one with etl_to_run's,
     one with the examples', one with the kernels' numbers, then the
     result line.
It imports nothing of JAX. Working files go to .chip_smoke/ beside it.
"""

from __future__ import annotations

import contextlib
import csv
import gzip
import importlib
import io
import json
import logging
import os
import runpy
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from medgp_tpu_torch.cli.main import main as cli
from medgp_tpu_torch.cluster.kde import kde_mode_batch
from medgp_tpu_torch.config.experiment import ExperimentConfig
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import PatientRecord, load_cohort, pack_patients
from medgp_tpu_torch.data.inits import default_bounds, random_inits
from medgp_tpu_torch.data.mimic_etl import (
    ALL_FEATURE_IDS, LAB_ITEMS, VITAL_BOUNDS, VITAL_ITEMS, extract_cohort_from_csvs,
)
from medgp_tpu_torch.data.synthetic import (
    cluster_thetas, sample_cluster_params, sample_cohort,
    write_reference_format_cohort,
)
from medgp_tpu_torch.evaluation.evals import mae_mean_se
from medgp_tpu_torch.infer.diagnostics import ess_bulk
from medgp_tpu_torch.infer import streams as st
from medgp_tpu_torch.infer.hmc import (
    _leapfrog, chain_starts, hmc_patient, hmc_sample, make_potential, repeat_rows,
)
from medgp_tpu_torch.infer.large_train import pad_observations
from medgp_tpu_torch.infer.map_train import screen_inits
from medgp_tpu_torch.infer.nuts import nuts_sample
from medgp_tpu_torch.infer.online import online_impute, unique_times
from medgp_tpu_torch.infer.vi import advi_fit
from medgp_tpu_torch.models.gp import PatientData, objective_and_grad
from medgp_tpu_torch.models.params import LMCSMSpec, theta_from_numpy
from medgp_tpu_torch.models.priors import clamp_a_elements, hier_gamma_prior
from medgp_tpu_torch.ops import cuda_build, cuda_chol, cuda_gram, objective
from medgp_tpu_torch.ops.nlml import jittered_chol_solve
from medgp_tpu_torch.cluster.pipeline import kernel_clustering_fold
from medgp_tpu_torch.infer.map_train import train_one_patient
from medgp_tpu_torch.parallel import mesh as mesh_module
from medgp_tpu_torch.parallel import runner
from medgp_tpu_torch.parallel.launch import init_distributed, rank_device
from medgp_tpu_torch.parallel.mesh import (
    cohort_mesh, large_patient_nlml, large_patient_objective, pad_batch_to,
    population_noise_modes_by_fold, round_up,
)
from medgp_tpu_torch.parallel.runner import (
    MAX_BATCH, TEST_MODES, _test_prior, hmc_cohort, test_cohort, train_cohort,
)
from medgp_tpu_torch.runtime import bindings
from medgp_tpu_torch.utils import hbm, metrics
from medgp_tpu_torch.visualization import fastkernel, vizkernel
from medgp_tpu_torch.visualization.printkernel import print_kernel_info

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
EXAMPLES = os.path.join(ROOT, "medgp_tpu_torch", "examples")
EXAMPLE_TIMEOUT = 300  # seconds for one example entry point
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
# The θ prologue and the gradient epilogue (csrc/theta.cuh): relative to
#     each output's largest entry; they sum over R, H and n in another order
#     than the twins (FMA chains and a tree against cuBLAS and torch.sum).
THETA_KERNEL_REL = 1e-5

# The train stage of the smoke, cut to run in seconds: 16 restarts (of
# 1,000) and top_iteration_num 2 (of 40), i.e. two varEM warm rounds of 100
# SCG evaluations each; the rest is examples/opt_prior2.json.
TRAIN_OPT = dict(
    random_init_num=16, random_seed=718, top_iteration_num=2,
    iteration_num_per_update=30, online_learn_rate=1e-5, online_momentum=0.9,
)

# The accuracy phase: tools/refbudget_run.sh's PT/INR cohort (seed 718,
# 100 patients, 3 latent clusters, 40-220 observations, features 18/19,
# LMC-SM Q=5 R=2, 10 folds) at the script's reduced budgets: 16 inits, two
# varEM rounds of 8 SCG evaluations; the rest is the defaults.
PTINR_SEED = 718
PTINR_OPT = dict(random_init_num=16, top_iteration_num=2, iteration_num_per_update=8)
# The JAX package's 16 restart draws for that arm (random_inits from
# jax.random.key(718)), written by tools/ptinr_jax_inits.py. The phase
# trains from them in place of the port's own torch.Generator draws, so
# that both packages' arms start from one initialisation, as the parity
# tests feed both the same inits: the bin-level SE below does not cover
# the spread between two sets of 16 draws (PERF.md §6).
PTINR_JAX_INITS = os.path.join(ROOT, "tools", "ptinr_jax_inits.json")
# The JAX package's MAE +- SE on that arm (mean, and SE = std (ddof 1) /
# sqrt(200), over the 200 per-(patient, feature) MAE values), which the
# port must match in each mode: one run of tools/refbudget_run.sh's second
# half with JAX_PLATFORMS=cpu (one device, the host KDE path) on five x86
# cores, 32 minutes; and, for mean_w_update, SCALE.md §6's reduced arm (a
# TPU v5e run, from the same draws).
JAX_PTINR_MAE = {
    "mean_wo_update": {"CPU run": (0.6216806508122743, 0.014926084397429972)},
    "mean_w_update": {"CPU run": (0.5500917315404386, 0.014420121124858307),
                      "SCALE.md §6 (TPU v5e)": (0.5382, 0.0141)},
}
MAE_SIGMAS = 3.0  # |MAE_port - MAE_jax| <= 3 combined standard errors
# The same cohort and budgets from the port's own restart draws (seed 718,
# no restart_draws), the path users run. Its MAE must lie in a 3-sd
# prediction interval of one new set of 16 draws from the population of
# the JAX package's draw sets: |MAE - mean_J| <= OWN_DRAW_SIGMAS * sd_J *
# sqrt(1 + 1/JAX_DRAW_SETS). mean_J and sd_J (ddof 1) are over the J arms
# of `python3 tools/ptinr_arms.py --paired`: the JAX package's draws of
# jax.random.key(s), s = 718, 1, ..., 9 (tools/ptinr_jax_inits_seeds.json),
# each trained through the port with random_seed = s; one chip run on an
# NVIDIA H100 80GB HBM3 at a 700 W power limit, 20 arms in one call (the
# paired table in PERF.md §6).
JAX_DRAW_SETS = 10
JAX_DRAWS_PTINR_MAE = {  # mode: (mean_J, sd_J)
    "mean_wo_update": (0.5766032268597993, 0.021460489618261518),
    "mean_w_update": (0.5254555727919448, 0.011568493291595351),
}
OWN_DRAW_SIGMAS = 3.0

# The samplers' phases: the CLI `hmc` with each sampler, and `run --sampler
# hmc`, at budgets cut to keep the three `hmc` phases near 3 minutes on the
# card (the CLI's defaults: 4 chains, 300 warmup, 300 draws, 16 steps).
SAMPLER_BUDGET = dict(chains=2, warmup=16, samples=16, leapfrog=8, max_depth=6)
SAMPLER_CLI = [x for k, v in SAMPLER_BUDGET.items()
               for x in (f"--{k.replace('_', '-')}", str(v))]
SAMPLER_RUN_CLI = SAMPLER_CLI[:6]  # `run` takes --chains, --warmup, --samples
# nuts_sample's warmup depth cap; the sampling depth is at most this + 1
# (the JAX package's rule, ROADMAP §C)
WARMUP_MAX_DEPTH = 4
# One leapfrog trajectory, kernels vs the float64 twins: theta relative to
# its scale.
THETA_REL = 1e-3
# ... and on a patient whose gram's conditioning takes the float32 twins'
# own trajectory past THETA_REL: tools/leapfrog_rows.py over 34 draws on
# the card put the kernels' worst row of such a patient at 4.2e-3 to
# 2.2e-2 (mean 1.0e-2, sd 3.8e-3; the twins' at 4.0e-3 to 3.1e-2), so
# above twice the kernels' worst, or the twins' own worst on the patient
# where that is larger.
THETA_ILL_REL = 5e-2
# bench.py's sampler protocol (bench.py:409-493); VI has none there: 32
# ADVI steps of 4 draws at the same batch.
BENCH = dict(batch=32, n=512, warmup=32, hmc_samples=24, leapfrog=16,
             nuts_samples=12, max_depth=6, vi_steps=32, vi_mc=4)

# The large-patient phases (parallel/mesh.py, infer/large_train.py) at
# canonical width: the blocked objective against the dense one at n = 4096
# over 4 row blocks; the CLI `train` on a cohort with one patient of 16,384
# observations (32 shifted copies of a 512-observation one), above the
# default threshold of 8,192, at 16 restarts and varEM 2 x 8; one
# value+gradient at n = 16,384 and at n = 65,536 on random data, each with
# its peak device memory against utils/hbm.py's rule.
LARGE_N, LARGE_BLOCKS = 4096, 4
LARGE_TRAIN_N, LARGE_TILE = 16384, 512
LARGE_OPT = dict(random_init_num=16, random_seed=718, top_iteration_num=2,
                 iteration_num_per_update=8)
LARGE_EVAL_N = (16384, 65536)

# The multi-rank phases: the row-sharded value+gradient at n = 16,384 over
# 4 row blocks of 4,096 (on one rank, and two blocks a rank on two); the
# mesh's float32 noise modes against the host float64 KDE (the JAX
# package's tolerance, tests/test_mesh.py:240); two ranks against one:
# the value and the gradient over the row's scale; each torchrun's time
# limit.
MESH_LARGE_N, MESH_LARGE_BLOCKS = 16384, 4
MESH_NOISE_REL = 2e-3
MESH_VALUE_REL = 1e-6
MESH_GRAD_TOL = 1e-5
RANKS_SHARED = 2
RANK_TIMEOUT = 420

# The ETL phase (etl_to_run): synthetic MIMIC-III tables (DIAGNOSES_ICD,
# ADMISSIONS, CHARTEVENTS, LABEVENTS as .csv.gz, the columns of MIMIC-III
# v1.4) from SEED, of 256 admissions: 190 with an ICD-9 428* code, of which
# 12 died, 12 have no chart data, 6 fail the ETL's first pass (3 values of
# one signal) and 8 pass it but fail the second (3 values of one signal in
# 0-72 h, 4 before admission); the other 66 are not heart failure (half
# with events). Each admission with events has 5-20 events per signal in
# 0-72 h, about a level drawn per admission (so n = 120-480 spreads over
# the buckets 128, 256 and 512), one of them at a repeated CHARTTIME, plus
# an out-of-bound value, an empty VALUENUM and a pre-admission event per
# signal; LABEVENTS adds rows with no HADM_ID; rows of other ITEMIDs,
# ETL_NOISE times the rows the ETL keeps, fill CHARTEVENTS to about 0.4M
# rows. MIMIC-III's CHARTEVENTS has about 330 million rows.
ETL_ADMISSIONS = dict(ok=152, dead=12, no_chart=12, fail_pass1=6, fail_pass2=8, other=66)
ETL_EVENTS = (5, 20)
ETL_NOISE = 10
ETL_LAB_SHARE = 0.1  # of the other ITEMIDs' rows, in LABEVENTS
# (typical value, relative spread) of each signal, in ALL_FEATURE_IDS order
ETL_VALUES = [
    (18, .2), (85, .15), (120, .15), (98.4, .008), (30, .4), (25, .12),
    (8.6, .08), (101, .04), (1.3, .5), (130, .3), (32, .15), (10.5, .15),
    (29.5, .08), (33, .04), (89, .07), (1.4, .3), (15, .2), (35, .3),
    (220, .4), (4.2, .12), (3.6, .15), (15, .12), (138, .03), (9.5, .4),
]
# fastkernel against K1: trained patients of the n = 512 bucket, with the
# gram tolerance of ROADMAP (1e-4 relative, 1e-5 absolute, per entry)
ETL_K1_PATIENTS = 8
GRAM_RTOL, GRAM_ATOL = 1e-4, 1e-5

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

# The five kernels by their wrappers' names, and the prefix of their
# counters in the program's table (utils/metrics.py: `<k>.launches`).
KERNELS = {
    "gram_lmcsm": "k1",
    "gram_lmcsm_bwd": "k2",
    "chol_solve": "k3",
    "qmat": "k4",
    "tri_inv": "k5",
    "theta_prologue": "theta_prologue",
    "theta_epilogue": "theta_epilogue",
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
    (objective, "theta_prologue", objective.theta_prologue_plain),
    (objective, "theta_epilogue", objective.theta_epilogue_plain),
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


_launches_at_reset = {}


def _launch_counts():
    table = metrics.snapshot()
    # the θ kernels' counters appear at their first launch
    return {name: int(table.get(k + ".launches", 0)) for name, k in KERNELS.items()}


def reset_launches():
    """Count launches from here on (`read_launches`)."""
    _launches_at_reset.update(_launch_counts())


def read_launches():
    """Each kernel's launches since the last `reset_launches` (since the
    process started, before the first)."""
    return {name: c - _launches_at_reset.get(name, 0) for name, c in _launch_counts().items()}


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


def compare_theta_kernels(dev, batch=128, n=512):
    """The fused objective's θ prologue and gradient epilogue against their
    twins at the train bucket's shape, under the batched hier-gamma prior
    with an A-element in ten clamped: each output within THETA_KERNEL_REL
    of its largest entry, and bitwise alike on repeat. Returns the rows of the
    kernels line (times by CUDA events, bound from the bytes each reads
    once and writes once)."""
    spec = LMCSMSpec(Q, D, R)
    data = random_patients(dev, batch, n, 6)
    data.mask[: batch // 2, n - 100:] = 0.0  # half the batch padded
    th = random_thetas(dev, spec, batch, 6)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    clamp = torch.rand((batch, Q * D * R), generator=gen, device=dev) < 0.1
    prior = clamp_a_elements(hier_gamma_prior(spec, beta_lam=0.01, device=dev).expand(batch),
                             spec, clamp)
    pro_args = (th, data.y, data.meta, data.mask, prior, spec)
    out = objective.theta_prologue(*pro_args)
    again = objective.theta_prologue(*pro_args)
    want = objective.theta_prologue_plain(*pro_args)
    dB = torch.randn((batch, Q, D, D), generator=gen, device=dev)
    dmu, dv = (torch.randn((batch, Q), generator=gen, device=dev) for _ in range(2))
    dKm = torch.randn((batch, n, n), generator=gen, device=dev)
    mult = torch.randint(1, 4, (batch,), generator=gen, device=dev, dtype=torch.int32)
    d_value = torch.ones(batch, device=dev)
    ok = torch.rand(batch, generator=gen, device=dev) < 0.9
    epi_args = (th, dB, dmu, dv, dKm, mult, data.meta, data.mask, d_value, ok, prior, spec)
    g = objective.theta_epilogue(*epi_args)
    g2 = objective.theta_epilogue(*epi_args)
    g_want = objective.theta_epilogue_plain(*epi_args)
    torch.cuda.synchronize()
    rel = {}  # each output's max abs err over its largest entry
    names = ("B", "mu", "v", "noise", "y_eff", "lp", "n_eff")
    for name, a, b, w in zip(names + ("dtheta",), out + (g,), again + (g2,), want + (g_want,)):
        check(torch.equal(a, b), f"theta kernels: {name} differs between two runs")
        err, scale = float((a - w).abs().max()), float(w.abs().max())
        rel[name] = err / scale if scale else err
        check(err <= THETA_KERNEL_REL * scale,
              f"theta kernels: {name} max abs err {err} > {THETA_KERNEL_REL} x {scale}")
    check(bool((g[~ok] == 0).all()), "theta epilogue: a row that is not ok has a gradient")
    H, reps = spec.n_hyp, 20
    # bytes: theta and the prior's fields (14 bytes a hyper) in, y, meta,
    # mask in and noise, y_eff out (20 bytes an observation), B, mu, v, lp,
    # n_eff out; the epilogue reads dKm's diagonal, dB, dmu, dv, meta, mask
    # and writes dtheta
    pro_bytes = batch * (18 * H + 20 * n + 4 * (Q * D * D + 2 * Q + 2))
    epi_bytes = batch * (22 * H + 12 * n + 4 * (Q * D * D + 2 * Q) + 9)
    rows = {}
    for name, fn, plain, args, flops, nbytes in (
        ("theta_prologue", objective.theta_prologue, objective.theta_prologue_plain, pro_args,
         batch * 2 * Q * D * D * R, pro_bytes),
        ("theta_epilogue", objective.theta_epilogue, objective.theta_epilogue_plain, epi_args,
         batch * 4 * Q * D * R * D, epi_bytes),
    ):
        bound_ms, bound_by = bound(flops, nbytes)
        mine = {k: v for k, v in rel.items() if (k == "dtheta") == (name == "theta_epilogue")}
        rows[name] = dict(
            max_abs_err=max(mine.values()),  # relative to each output's scale
            ms=cuda_ms(lambda: fn(*args), reps), plain_ms=cuda_ms(lambda: plain(*args), reps),
            device_ms=graph_ms(lambda: fn(*args), reps),
            library_ms=None, bound_ms=bound_ms, bound_by=bound_by)
        print(f"{name} B={batch} n={n}: max abs err over max |twin| "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in mine.items()})} (tol "
              f"{THETA_KERNEL_REL:g}), bitwise equal on repeat; kernel {rows[name]['ms']:.4f} ms "
              f"(device alone, CUDA graph: {rows[name]['device_ms']:.4f} ms), twin "
              f"{rows[name]['plain_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return rows


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


def generate_experiment(prefix, feature_config, opt, Q, R, folds, cohort="synth"):
    """CLI `generate` of an LMC-SM hier-gamma experiment under
    .chip_smoke/exp/ from the cohort staged in .chip_smoke/data/{cohort};
    returns its exp_setup.json."""
    opt_path = os.path.join(WORK, f"opt_{prefix}.json")
    with open(opt_path, "w") as f:
        json.dump(opt, f)
    cli([
        "generate", "--data-root", os.path.join(WORK, "data"),
        "--exp-root", os.path.join(WORK, "exp"), "--cohort", cohort,
        "--feature-config", feature_config, "--opt-config", opt_path,
        "--kernel", "LMC-SM", "--prior", "hier-gamma", "--Q", str(Q),
        "--R", str(R), "--eta", "0.01", "--beta-lam", "0.01",
        "--cv-fold-num", str(folds), "--exp-prefix", prefix,
    ])
    return os.path.join(
        WORK, "exp", f"{prefix}_k7_q{Q}_r{R}_p2_e0.01", "config", "exp_setup.json"
    )


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
    cfg_path = generate_experiment("smoke", feature_config, TRAIN_OPT, Q=Q, R=R, folds=10)
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


def run_example(name, cmd, needs, env=None):
    """One of the port's example entry points as a user starts it (`cmd`, a
    process of its own, on the card), in a session of its own that is
    killed at EXAMPLE_TIMEOUT; its log goes to .chip_smoke/{name}.log. A
    shell script's $PYTHON is a stand-in that runs the module through this
    script's `--rank exec` mode, and a `torchrun` runs this script in its
    place (`{out}` in `cmd` names the directory of its record), so the
    child counts its own launches (set to 0 at its start); every kernel in
    `needs` must have launched. Returns (seconds, counts, standard output,
    the child's record)."""
    torch.cuda.empty_cache()
    out_dir = os.path.join(WORK, "examples", name)
    os.makedirs(out_dir, exist_ok=True)
    stand_in = os.path.join(out_dir, "python")
    with open(stand_in, "w") as f:
        f.write(f'#!/bin/bash\nexec "{sys.executable}" "{os.path.abspath(__file__)}" '
                f'--rank exec "{out_dir}" "$@"\n')
    os.chmod(stand_in, 0o755)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [x.replace("{out}", out_dir) for x in cmd], cwd=ROOT, text=True,
        env={**os.environ, "PYTHON": stand_in, **(env or {})}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=EXAMPLE_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    with open(os.path.join(WORK, f"{name}.log"), "w") as f:
        f.write(out + err)
    check(proc.returncode == 0, f"{name}: exited {proc.returncode} after {seconds:.0f} s; "
          f"the end of its log:\n{(out + err)[-3000:]}")
    if not needs:
        return seconds, {}, out, {}
    (child,), counts = rank_counts(out_dir, "exec", world=1)
    print(f"{name}: {seconds:.2f} s ({child['seconds']:.2f} s in the child); peak device "
          f"memory {child['peak_bytes'] / 2**30:.2f} GiB; launches {counts}")
    for k in needs:
        check(counts[k] > 0, f"{name} never launched {k}")
    return seconds, counts, out, child


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


def run_fused(name, cfg_path, dev):
    """The CLI `run` through run_path (every kernel must launch); returns
    (seconds, counts, {mode: summary}) with the summary line it printed."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        seconds, counts = run_path(
            name, ["run", "--cfg", cfg_path, "--device", str(dev)], tuple(KERNELS))
    text = out.getvalue()
    print(text, end="")
    return seconds, counts, run_summary(name, text)


def run_summary(name, text):
    """The {mode: summary} line `run` printed last; every number finite."""
    summary = json.loads([x for x in text.splitlines() if x.startswith("{")][-1])
    for mode in TEST_MODES:
        for k in ("mae", "ci_ratio", "nll"):
            check(np.isfinite(summary[mode][k]), f"{name}: {mode} {k} not finite")
    return summary


def check_mode_kernels(cfg, folds):
    """Every fold's gmm mode kernel: finite, 1 <= newQ <= Q, the length
    of an LMC-SM(newQ, D, R) theta."""
    got = {}
    for fold in folds:
        theta, newQ = formats.read_mode_kernel(cfg.exp_kernel_dir, fold, "gmm")
        check(1 <= newQ <= cfg.Q, f"fold {fold}: {newQ} mode components")
        check(theta.shape == (LMCSMSpec(newQ, cfg.D, cfg.R).n_hyp,),
              f"fold {fold}: mode theta of {theta.shape}")
        check(bool(np.all(np.isfinite(theta))), f"fold {fold}: mode theta not finite")
        got[fold] = (theta, newQ)
    print(f"mode kernels: components by fold {({f: q for f, (_, q) in got.items()})}")
    return got


def run_stage_seconds(cfg):
    """The `run` record of log/metrics.jsonl: each stage's seconds."""
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        rec = [json.loads(x) for x in f if '"stage": "run"' in x][-1]
    return {k[: -len("_seconds")]: rec[k] for k in rec if k.endswith("_seconds")}


def run_full_width(dev):
    """`run` at the canonical width on the staged 64-patient cohort, two
    folds, through the port's example script run_pipeline.sh on the card
    (a process of its own, counted by `run_example`); then the staged
    `kernclust --fold -1` and `eval` on its files."""
    cfg_path = generate_experiment(
        "run", os.path.join(ROOT, "examples", "feature_all.json"), TRAIN_OPT,
        Q=Q, R=R, folds=2)
    cfg = ExperimentConfig.from_json(cfg_path)
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    seconds, counts, stdout, _ = run_example(
        "run_pipeline.sh", ["bash", os.path.join(EXAMPLES, "run_pipeline.sh"), cfg_path,
                            "--device", dev.type], tuple(KERNELS))
    summary = run_summary("run_pipeline.sh", stdout)
    check_train_outputs(cfg, recs)
    modes = check_mode_kernels(cfg, (-1, 0, 1))
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    stages = run_stage_seconds(cfg)
    print(f"run (full width): stage seconds {json.dumps(stages)}; summary "
          f"{json.dumps(summary)}")
    cli(["kernclust", "--cfg", cfg_path, "--fold", "-1", "--device", str(dev)])
    theta, newQ = formats.read_mode_kernel(cfg.exp_kernel_dir, -1, "gmm")
    d = float(np.abs(theta - modes[-1][0]).max()) if newQ == modes[-1][1] else np.inf
    print(f"kernclust --fold -1 from the files: {newQ} components, max |d theta| "
          f"against run's in-memory handoff {d:.3e}")
    check(newQ == modes[-1][1] and np.array_equal(theta, modes[-1][0]),
          "kernclust from run's train files differs from run's handoff")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli(["eval", "--cfg", cfg_path, "--test-mode", "mean_w_update"])
    ev = json.loads(out.getvalue().strip().splitlines()[-1])
    print(f"eval mean_w_update: {json.dumps(ev)}")
    check(ev == summary["mean_w_update"], "eval's summary differs from run's")
    return seconds, counts, stages


def stage_ptinr(prefix, opt):
    """Stage the PT/INR cohort under .chip_smoke/data/ptinr and `generate`
    its 10-fold experiment; returns (cfg_path, recs)."""
    recs = sample_cohort(PTINR_SEED, LMCSMSpec(5, 2, 2), n_patients=100,
                         n_clusters=3, n_obs_range=(40, 220))
    write_reference_format_cohort(os.path.join(WORK, "data", "ptinr"), recs, [18, 19])
    cfg_path = generate_experiment(
        prefix, os.path.join(ROOT, "examples", "feature_PT_INR.json"),
        opt, Q=5, R=2, folds=10, cohort="ptinr")
    return cfg_path, recs


def jax_ptinr_inits():
    """The JAX package's restart draws for the PT/INR arm, (16, H) float32."""
    with open(PTINR_JAX_INITS) as f:
        return torch.tensor(json.load(f)["inits"], dtype=torch.float32)


@contextlib.contextmanager
def restart_draws(inits):
    """Train from `inits` in place of the port's own restart draws; fails
    unless the train stage asked for exactly that many."""
    drawn = []

    def given(seed, spec, bounds, n):
        check(tuple(inits.shape) == (n, spec.n_hyp),
              f"restart draws of {tuple(inits.shape)}, train asks ({n}, {spec.n_hyp})")
        drawn.append(n)
        return inits.clone()

    own = runner.random_inits
    runner.random_inits = given
    try:
        yield
    finally:
        runner.random_inits = own
    check(len(drawn) == 1, f"train drew its restarts {len(drawn)} times")


def run_accuracy(dev):
    """`run` on the PT/INR cohort at the reduced budgets from the JAX
    package's restart draws: both modes' outputs complete and finite, and
    each mode's MAE within MAE_SIGMAS combined standard errors of the JAX
    package's."""
    cfg_path, recs = stage_ptinr("ptinr", PTINR_OPT)
    cfg = ExperimentConfig.from_json(cfg_path)
    with restart_draws(jax_ptinr_inits()):
        seconds, counts, summary = run_fused("run (PT/INR accuracy)", cfg_path, dev)
    check_mode_kernels(cfg, range(-1, cfg.cv_fold_num))
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    stages = run_stage_seconds(cfg)
    got = {m: mae_mean_se(cfg.exp_test_dir, m, cfg.feature_list) for m in TEST_MODES}
    for mode in TEST_MODES:
        m, se, n = got[mode]
        for arm, (mj, sej) in JAX_PTINR_MAE[mode].items():
            lim = MAE_SIGMAS * float(np.hypot(se, sej))
            print(f"PT/INR {mode}: port MAE {m:.4f} +- {se:.4f} (N={n}), JAX package "
                  f"({arm}) {mj:.4f} +- {sej:.4f}; |d| {abs(m - mj):.4f} against "
                  f"{MAE_SIGMAS:g} combined SE {lim:.4f}")
            check(abs(m - mj) <= lim, f"PT/INR {mode}: MAE {m} is {abs(m - mj)} "
                  f"from the JAX package's {mj} ({arm}), above {lim}")
    print(f"run (PT/INR): stage seconds {json.dumps(stages)}; summary "
          f"{json.dumps(summary)}")
    return seconds, counts, stages, got


def run_own_draws(dev):
    """`run` on the PT/INR cohort at the reduced budgets from the port's own
    restart draws (seed 718): both modes' outputs complete and finite, and
    each mode's MAE within OWN_DRAW_SIGMAS sd_J sqrt(1 + 1/JAX_DRAW_SETS) of
    mean_J (JAX_DRAWS_PTINR_MAE)."""
    cfg_path, recs = stage_ptinr("ptinr_own", PTINR_OPT)
    cfg = ExperimentConfig.from_json(cfg_path)
    seconds, counts, summary = run_fused("run (PT/INR, own draws)", cfg_path, dev)
    check_mode_kernels(cfg, range(-1, cfg.cv_fold_num))
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    stages = run_stage_seconds(cfg)
    got = {m: mae_mean_se(cfg.exp_test_dir, m, cfg.feature_list) for m in TEST_MODES}
    for mode in TEST_MODES:
        m, se, n = got[mode]
        mj, sdj = JAX_DRAWS_PTINR_MAE[mode]
        lim = OWN_DRAW_SIGMAS * sdj * float(np.sqrt(1 + 1 / JAX_DRAW_SETS))
        print(f"PT/INR {mode}, own draws: port MAE {m:.4f} +- {se:.4f} (N={n}); "
              f"JAX package's draw sets {mj:.4f}, sd {sdj:.4f} over "
              f"{JAX_DRAW_SETS}; |d| {abs(m - mj):.4f} against {lim:.4f}")
        check(abs(m - mj) <= lim, f"PT/INR {mode} from the port's own draws: MAE "
              f"{m} is {abs(m - mj)} from the JAX draw sets' {mj}, above {lim}")
    print(f"run (PT/INR, own draws): stage seconds {json.dumps(stages)}; summary "
          f"{json.dumps(summary)}")
    return seconds, counts, stages, got


# --------------------------------------------------------------------------
# the posterior samplers (after `train`, on its trained experiment)
# --------------------------------------------------------------------------

@contextlib.contextmanager
def recorded(module, name):
    """Keep every result of `module.name` made meanwhile (a list)."""
    own, seen = getattr(module, name), []

    def wrapped(*args, **kwargs):
        seen.append(own(*args, **kwargs))
        return seen[-1]

    setattr(module, name, wrapped)
    try:
        yield seen
    finally:
        setattr(module, name, own)


def sampler_bucket(cfg, dev, chains):
    """The trained cohort's n=512 bucket as `hmc_cohort` packs it for
    `chains` chains, with its MAP hypers and the hier-gamma prior."""
    spec = cfg.spec()
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    pans, hyps = formats.read_train_kernels(cfg.exp_train_dir, cfg.pans())
    by_pan = dict(zip(pans, hyps))
    b = max(pack_patients([r for r in recs if r.pan in by_pan], max_batch=32,
                          device=dev, footprint_mult=2 * chains), key=lambda x: x.n_max)
    theta0 = torch.as_tensor(np.stack([by_pan[p] for p in b.pans]).astype(np.float32), device=dev)
    prior = hier_gamma_prior(spec, beta_lam=cfg.beta_lam, device=dev)
    return spec, b, runner.batch_data(b, dev), theta0, prior


def sampler_potential_and_leapfrog(cfg, dev, chains=4, steps=16, eps=2e-4):
    """The HMC potential (K1, K3, K4, K2) on the n=512 bucket's (patient,
    chain) rows, and one leapfrog trajectory of `steps` steps from the same
    momenta (the rows' streams; unit mass, `eps` small enough that no
    row diverges), through the kernels, the float32 twins and the twins in
    float64. The MAP points of trained patients include ill-conditioned
    grams, on which the float32 twins' gradient misses the float64 one by
    up to ~20% (PERF.md §6), so the kernels are held to the float64
    twins: U within VALUE_REL; dU within GRAD_TOL of each row's scale, or
    no further off than the float32 twins on that row; theta at the
    trajectory's end within THETA_REL of each row's scale on every chain
    of each patient on whose every chain the float32 twins' trajectory is;
    on an ill-conditioned patient the trajectory grows float32 rounding,
    from either path, past THETA_REL at any step size that moves the other
    rows, and which of its chains stays within is a matter of the draw
    (tools/leapfrog_rows.py), so every chain of a patient on a chain of
    which the twins leave THETA_REL is held within THETA_ILL_REL, or within
    the twins' worst row of that patient where that is larger (those rows
    are printed). The trajectory, not a transition: an accept draw near
    its threshold may flip."""
    spec, b, data, theta0, prior = sampler_bucket(cfg, dev, chains)
    gmask = prior.grad_mask()
    streams = st.patient_streams(SEED, range(theta0.shape[0]), dev)
    th = chain_starts(theta0, streams, chains, gmask).reshape(-1, spec.n_hyp)
    ((w0, w1),) = st.words(st.with_chains(streams, chains), 0,
                           ((st.HMC_MOMENTUM, spec.n_hyp),))
    p = st.normal(w0, w1, th.dtype)
    rows = repeat_rows(data, chains)
    rows64 = PatientData(rows.t.double(), rows.y.double(), rows.meta, rows.mask.double())

    def run(data, th, p):
        pg = make_potential(spec, data, prior)
        u, g = pg(th)
        step = torch.full((th.shape[0],), eps, dtype=th.dtype, device=dev)
        end = _leapfrog(pg, th, p, g * gmask, u, step, torch.ones_like(th), steps, steps,
                        gmask.to(th.dtype))[0]
        return u, g, end

    u, g, end = run(rows, th, p)
    with twins():
        ut, gt, end_t = run(rows, th, p)
        u64, g64, end64 = run(rows64, th.double(), p.double())
    torch.cuda.synchronize()
    check(bool(torch.isfinite(u).all()) and bool(torch.isfinite(u64).all()),
          "sampler potential: a failed evaluation at the MAP starts")

    def u_err(x):
        return float(((x.double() - u64) / u64).abs().max())

    def row_err(x, ref):  # per row, relative to the row's float64 scale
        return (x.double() - ref).abs().amax(-1) / ref.abs().amax(-1)

    ek, et = row_err(g, g64), row_err(gt, g64)
    th_k, th_t = row_err(end, end64), row_err(end_t, end64)
    print(f"sampler potential n_max={b.n_max} B={len(b)} x {chains} chains = {th.shape[0]} "
          f"rows, against the float64 twins: U rel err kernels {u_err(u):.3e}, float32 twins "
          f"{u_err(ut):.3e} (tol {VALUE_REL:g}); dU row-relative err kernels max "
          f"{float(ek.max()):.3e} median {float(ek.median()):.3e}, float32 twins max "
          f"{float(et.max()):.3e} median {float(et.median()):.3e} (tol {GRAD_TOL:g} or the "
          f"twins' own); kernels vs float32 twins U {float(((u - ut) / ut).abs().max()):.3e}, "
          f"dU {float((g - gt).abs().max() / gt.abs().max()):.3e} of scale; {steps}-step "
          f"leapfrog (eps {eps:g}) end theta row-relative err kernels max "
          f"{float(th_k.max()):.3e} median {float(th_k.median()):.3e}, float32 twins max "
          f"{float(th_t.max()):.3e} (tol {THETA_REL:g}) after moving "
          f"{float((end64 - th.double()).abs().max()):.3e}")
    # a patient's chains share its gram's conditioning (their starts differ
    # by a 0.01 jitter)
    twins_worst = th_t.reshape(-1, chains).amax(-1).repeat_interleave(chains)
    held = twins_worst <= THETA_REL
    ill_bound = torch.clamp(twins_worst, min=THETA_ILL_REL)
    loose = torch.nonzero(~held).squeeze(-1).tolist()
    print(f"leapfrog: rows of the patients on a chain of which the float32 twins' trajectory "
          f"leaves {THETA_REL:g} of the float64 one, held within {THETA_ILL_REL:g} or the "
          f"twins' worst on the patient (patient, chain; kernels' err, twins' err, kernels' "
          f"dU err, twins'): "
          f"{[(i // chains, i % chains, float(th_k[i]), float(th_t[i]), float(ek[i]), float(et[i])) for i in loose]}")
    check(u_err(u) <= VALUE_REL, f"sampler potential: U rel err {u_err(u)} > {VALUE_REL}")
    worst = int(torch.argmax(ek - torch.clamp(et, min=GRAD_TOL)))
    check(bool((ek <= torch.clamp(et, min=GRAD_TOL)).all()),
          f"sampler potential: row {worst} dU err {float(ek[worst])} above {GRAD_TOL} and "
          f"the float32 twins' {float(et[worst])}")
    check(bool((th_k[held] <= THETA_REL).all()),
          f"leapfrog: theta err {float(th_k[held].max())} > {THETA_REL} on a patient the "
          f"float32 twins hold")
    worst = int(torch.argmax(torch.where(held, -1.0, th_k / ill_bound)))
    check(bool((th_k[~held] <= ill_bound[~held]).all()),
          f"leapfrog: theta err {float(th_k[worst])} of row {worst} (patient "
          f"{worst // chains}) > {float(ill_bound[worst])}, the larger of {THETA_ILL_REL:g} "
          f"and the float32 twins' worst on the patient")
    return th.shape[0]


def check_sampler_outputs(cfg, sampler):
    """Both files of every trained patient, finite; accept rates in (0, 1],
    step sizes finite and > 0 and the diagnostics' keys (HMC, NUTS), or a
    finite ELBO (VI). Returns {pan: samples}."""
    prefix = "vi" if sampler == "vi" else "hmc"
    spec = cfg.spec()
    pans, _ = formats.read_train_kernels(cfg.exp_train_dir, cfg.pans())
    got = {}
    for pan in pans:
        mean_path = os.path.join(cfg.exp_train_dir, f"train_{prefix}_mean_{pan}.bin")
        npz_path = os.path.join(cfg.exp_train_dir, f"train_{prefix}_samples_{pan}.npz")
        check(os.path.exists(mean_path) and os.path.exists(npz_path),
              f"{pan}: missing {sampler} outputs")
        mean = formats.read_double_bin(mean_path)
        check(mean.shape == (spec.n_hyp,) and bool(np.all(np.isfinite(mean))),
              f"{pan}: {sampler} posterior mean")
        with np.load(npz_path) as z:
            check(bool(np.all(np.isfinite(z["samples"]))), f"{pan}: {sampler} samples not finite")
            if sampler == "vi":
                check(bool(np.isfinite(z["elbo"])), f"{pan}: ELBO not finite")
            else:
                acc, eps = z["accept_rate"], z["step_size"]
                check(bool(np.all((acc > 0) & (acc <= 1))), f"{pan}: accept rates {acc}")
                check(bool(np.all(np.isfinite(eps) & (eps > 0))), f"{pan}: step sizes {eps}")
                for k in ("ess_bulk_min", "rhat_max", "ess_min_A", "rhat_max_kappa"):
                    check(k in z.files, f"{pan}: no {k} in the {sampler} diagnostics")
            got[pan] = z["samples"]
    return got


def run_samplers(cfg_path, cfg, dev):
    """The CLI `hmc` with each sampler at SAMPLER_CLI's budgets, each
    through run_path (K1-K4 must launch; K5's kernels run inside each K4
    launch), every output checked; NUTS's depth within WARMUP_MAX_DEPTH +
    1; a second `hmc --sampler hmc` repeats the draws bitwise. Returns
    {sampler: (seconds, counts, extra)}."""
    needs = ("gram_lmcsm", "gram_lmcsm_bwd", "chol_solve", "qmat")
    base = ["hmc", "--cfg", cfg_path, "--device", str(dev), *SAMPLER_CLI]
    out = {}
    for sampler in ("hmc", "nuts", "vi"):
        with recorded(runner, f"{sampler}_patient") as results:
            seconds, counts = run_path(f"hmc --sampler {sampler}", base + ["--sampler", sampler], needs)
        samples = check_sampler_outputs(cfg, sampler)
        extra = dict(patients=len(samples), buckets=len(results))
        if sampler == "nuts":
            depth = max(int(r.tree_depth.max()) for r in results)
            transitions = len(results) * (SAMPLER_BUDGET["warmup"] + SAMPLER_BUDGET["samples"])
            reads = sum(r.host_reads for r in results)
            extra.update(max_depth=depth, host_reads=reads,
                         host_reads_per_draw=reads / transitions)
            check(depth <= WARMUP_MAX_DEPTH + 1,
                  f"NUTS sampled at depth {depth} > warmup_max_depth + 1")
        if sampler != "vi":
            rates = np.concatenate([r.accept_rate.cpu().numpy().ravel() for r in results])
            extra.update(accept_rate_mean=float(rates.mean()))
        print(f"hmc --sampler {sampler}: {len(samples)} patients in {len(results)} buckets, "
              f"{json.dumps(extra)}")
        out[sampler] = (seconds, counts, extra)
        if sampler == "hmc":
            cli(base + ["--sampler", "hmc"])
            again = check_sampler_outputs(cfg, "hmc")
            for pan, s in samples.items():
                check(np.array_equal(s, again[pan]), f"{pan}: a second hmc run differs")
            print(f"hmc --sampler hmc: a second run repeats all {len(again)} patients' "
                  f"draws bitwise")
            hmc_draws = samples
    return out, hmc_draws


def run_with_sampler(dev):
    """`run --sampler hmc` at the canonical width on the staged 64-patient
    cohort, two folds, at SAMPLER_BUDGET's chains, warmup and draws: the
    log shows the posterior-mean handoff for every trained patient, the
    `run` record has sampler_seconds, and both test modes' outputs are
    complete and finite."""
    cfg_path = generate_experiment(
        "runs", os.path.join(ROOT, "examples", "feature_all.json"), TRAIN_OPT,
        Q=Q, R=R, folds=2)
    cfg = ExperimentConfig.from_json(cfg_path)
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    lines = []
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    logging.getLogger("medgp_tpu_torch").addHandler(handler)
    try:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            seconds, counts = run_path(
                "run --sampler hmc", ["run", "--cfg", cfg_path, "--device", str(dev),
                                      "--sampler", "hmc", *SAMPLER_RUN_CLI], tuple(KERNELS))
    finally:
        logging.getLogger("medgp_tpu_torch").removeHandler(handler)
    trained = check_train_outputs(cfg, recs)
    handoff = [x for x in lines if "posterior means for" in x]
    print(f"run --sampler hmc: {handoff}")
    check(handoff and handoff[-1].split("posterior means for ")[1].startswith(
        f"{trained}/{trained} patients"), f"run --sampler hmc: handoff {handoff}")
    check_sampler_outputs(cfg, "hmc")
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    stages = run_stage_seconds(cfg)
    check(stages.get("sampler", 0) > 0, f"run record without sampler_seconds: {stages}")
    summary = json.loads([x for x in out.getvalue().splitlines() if x.startswith("{")][-1])
    print(f"run --sampler hmc: stage seconds {json.dumps(stages)}; summary {json.dumps(summary)}")
    return seconds, counts, stages


def gaussian_moments(dev):
    """The JAX tests' Gaussian targets on the card (tests/test_hmc.py:21-39,
    tests/test_nuts.py:79-96, tests/test_vi.py:15-38; VI over 16
    independent fits, as tests/test_torch_vi.py holds it)."""
    mu = torch.tensor([1.0, -2.0, 0.5], device=dev)
    sigma = torch.tensor([0.5, 2.0, 1.0], device=dev)

    def pg(x):
        return torch.sum(0.5 * ((x - mu) / sigma) ** 2, -1), (x - mu) / sigma**2

    one = st.patient_streams(SEED, [0], dev)
    got = {}
    for name, res in (
        ("hmc", hmc_sample(pg, torch.zeros(1, 3, device=dev), one, num_warmup=500,
                           num_samples=2000, num_leapfrog=16, init_step_size=0.1)),
        ("nuts", nuts_sample(pg, torch.zeros(1, 3, device=dev), one, num_warmup=400,
                             num_samples=1500, max_depth=6, init_step_size=0.1)),
    ):
        s = res.samples[0].cpu().numpy()
        m_err = float(np.abs(s.mean(0) - mu.cpu().numpy()).max())
        sd_err = float(np.abs(s.std(0) / sigma.cpu().numpy() - 1).max())
        got[name] = dict(accept_rate=float(res.accept_rate[0]), mean_err=m_err, std_rel_err=sd_err)
        check(float(res.accept_rate[0]) > 0.6 and int(res.divergences[0]) == 0,
              f"{name} Gaussian: accept {float(res.accept_rate[0])}, divergences")
        check(m_err <= 0.25 and sd_err <= 0.35, f"{name} Gaussian moments: {got[name]}")
    res = advi_fit(pg, torch.zeros(16, 3, device=dev), st.patient_streams(SEED, range(16), dev),
                   num_steps=1500, num_mc=8, learning_rate=0.05)
    m_err = float((res.mean.mean(0) - mu).abs().max())
    sd_err = float((res.log_std.exp().mean(0) / sigma - 1).abs().max())
    got["vi"] = dict(mean_err=m_err, std_rel_err=sd_err)
    check(bool(res.converged.all()) and m_err <= 0.1 and sd_err <= 0.2,
          f"vi Gaussian: {got['vi']}")
    print(f"Gaussian targets on {torch.cuda.get_device_name(0)}: {json.dumps(got)} "
          f"(tol: mean 0.25 / 0.25 / 0.1, std 0.35 / 0.35 / 0.2 relative)")
    return got


def sampler_rates(dev):
    """bench.py's sampler protocol (bench.py:409-493) through the kernels:
    B=32 random patients at n=512 (its data, seed 2), the canonical width,
    the hier-gamma prior, one chain per patient, each sampler run once to
    warm up and once timed. HMC: 32 warmup and 24 draws of 16 leapfrog
    steps; NUTS: 32 warmup, 12 draws, max_depth 6; both give draws/s
    (warmup inside the timed call, not counted) and the min-over-hypers
    bulk ESS summed over patients per second. VI (no bench protocol): 32
    ADVI steps of 4 draws, steps/s. Objective batches (K2 launches) and,
    for NUTS, host reads per transition are counted in the timed run. Each
    patient draws from its own stream (seed 0, its row as its key)."""
    spec = LMCSMSpec(Q, D, R)
    rng = np.random.default_rng(2)
    B, n = BENCH["batch"], BENCH["n"]
    t = np.sort(rng.uniform(0, 168.0, size=(B, n)), 1).astype(np.float32)
    meta = rng.integers(0, D, size=(B, n)).astype(np.int32)
    y = rng.normal(size=(B, n)).astype(np.float32)
    th = (rng.normal(size=(B, spec.n_hyp)) * 0.1).astype(np.float32)
    th[:, :D] = np.log(0.3)
    data = PatientData(*(torch.as_tensor(x, device=dev) for x in (t, y, meta, np.ones_like(t))))
    prior = hier_gamma_prior(spec, beta_lam=0.01, device=dev)
    gmask = prior.grad_mask()
    theta0 = torch.as_tensor(th, device=dev)
    streams = st.patient_streams(0, range(B), dev)
    warm = BENCH["warmup"]
    runs = {
        "hmc": (BENCH["hmc_samples"], lambda pg, g: hmc_sample(
            pg, theta0, g, num_warmup=warm, num_samples=BENCH["hmc_samples"],
            num_leapfrog=BENCH["leapfrog"], grad_mask=gmask)),
        "nuts": (BENCH["nuts_samples"], lambda pg, g: nuts_sample(
            pg, theta0, g, num_warmup=warm, num_samples=BENCH["nuts_samples"],
            max_depth=BENCH["max_depth"], grad_mask=gmask)),
    }
    out = {}
    for name, (draws, fn) in runs.items():
        pg = make_potential(spec, data, prior)
        for _ in range(2):  # a warm-up run, then the timed one
            reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(pg, streams)
            samples = res.samples.cpu().numpy()
            dt = time.perf_counter() - t0
        batches = read_launches()["gram_lmcsm_bwd"]
        ess = sum(float(np.min(ess_bulk(samples[b][None]))) for b in range(B))
        out[name] = dict(seconds=dt, draws_per_s=B * draws / dt, min_ess_per_s=ess / dt,
                         accept_rate=float(res.accept_rate.mean()),
                         objective_batches=batches,
                         batches_per_transition=batches / (warm + draws))
        if name == "nuts":
            out[name].update(host_reads=res.host_reads,
                             host_reads_per_transition=res.host_reads / (warm + draws),
                             mean_depth=float(res.tree_depth.float().mean()))
        check(np.isfinite(samples).all(), f"bench {name}: non-finite draws")
    pg = make_potential(spec, repeat_rows(data, BENCH["vi_mc"]), prior)
    for _ in range(2):  # a warm-up run, then the timed one
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = advi_fit(pg, theta0, streams, num_steps=BENCH["vi_steps"], num_mc=BENCH["vi_mc"],
                       grad_mask=gmask)
        res.mean.cpu()
        dt = time.perf_counter() - t0
    check(bool(torch.isfinite(res.mean).all()), "bench vi: non-finite mean")
    out["vi"] = dict(seconds=dt, steps_per_s=BENCH["vi_steps"] / dt,
                     objective_batches=read_launches()["gram_lmcsm_bwd"])
    print(f"sampler rates, bench.py's protocol (B={B}, n={n}, Q={Q} D={D} R={R}) on "
          f"{torch.cuda.get_device_name(0)}: {json.dumps(out)}")
    return out


def map_like_theta(spec, dev, seed):
    """A cluster's ground-truth hypers (the MAP a patient of that cluster
    trains toward), jittered by 0.01 N(0, 1): (1, H) on `dev`."""
    th = cluster_thetas(SEED, spec, 4)[0]
    th = th + 0.01 * np.random.default_rng(seed).normal(size=th.shape)
    return torch.as_tensor(th.astype(np.float32), device=dev)[None]


def rel_errs(v, g, v_ref, g_ref):
    """(value relative error, gradient max error over the reference row's
    scale) of one objective row."""
    v_err = float(((v.double() - v_ref.double()) / v_ref.double()).abs().max())
    g_err = float((g.double() - g_ref.double()).abs().max() / g_ref.double().abs().max())
    return v_err, g_err


def diag_block_times(dev, n, reps=5):
    """K3 and K5 on one (n, n) diagonal block (B = 1, zero noise, as the
    blocked factorization calls them) against `cholesky_ex` of the same
    block and `solve_triangular(L, I)`."""
    gen = torch.Generator(device=dev).manual_seed(SEED)
    A = torch.randn((1, n, n), generator=gen, device=dev)
    K = A @ A.mT / n + 0.5 * torch.eye(n, device=dev)
    zeros = torch.zeros((1, n), device=dev)
    L, _, linvd = cuda_chol.chol_solve(K, zeros, zeros)
    tm = time_chol(K, zeros, zeros, L, linvd, reps)
    tm["cholesky_ex_ms"] = cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps)
    tm["cluster"] = cuda_chol.chol_cluster_size(1, n)
    print(f"large-patient diagonal block n={n} (B=1, cluster {tm['cluster']}): "
          f"chol_solve {tm['chol_ms']:.3f} ms, cholesky_ex {tm['cholesky_ex_ms']:.3f} ms, "
          f"cholesky_ex + cholesky_solve {tm['chol_library_ms']:.3f} ms, bound "
          f"{tm['chol_bound_ms']:.3f} ms; tri_inv {tm['tri_ms']:.3f} ms, "
          f"solve_triangular {tm['tri_library_ms']:.3f} ms, bound {tm['tri_bound_ms']:.3f} ms")
    return {k: tm[k] for k in ("chol_ms", "cholesky_ex_ms", "chol_library_ms",
                               "chol_bound_ms", "tri_ms", "tri_library_ms",
                               "tri_bound_ms", "cluster")}


def large_blocked_vs_dense(dev):
    """The blocked objective (n = 4096 over 4 row blocks of 1024, K3 and K5
    on every diagonal block) against the dense one of `objective_and_grad`
    on the same patient (K1-K5 at B = 1) and against the float64 twins'
    dense objective, at jittered MAP-like hypers under the hier-gamma
    prior: value within VALUE_REL, gradient within GRAD_TOL of the row's
    scale. Returns (launch counts of the blocked run, the numbers)."""
    spec = LMCSMSpec(Q, D, R)
    data = random_patients(dev, 1, LARGE_N, 11)
    theta = map_like_theta(spec, dev, 11)
    prior = hier_gamma_prior(spec, beta_lam=0.01, device=dev)
    f = large_patient_objective(spec, LARGE_BLOCKS, *(x[0] for x in data), prior=prior)
    reset_launches()
    v, g, ok = f(theta)
    torch.cuda.synchronize()
    counts = read_launches()
    check(counts["chol_solve"] >= LARGE_BLOCKS and counts["tri_inv"] >= LARGE_BLOCKS,
          f"blocked objective: K3/K5 launches {counts}")
    t0 = time.perf_counter()
    v2, g2, _ = f(theta)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    # no atomics in the path: a patient's training repeats bitwise
    check(torch.equal(v, v2) and torch.equal(g, g2),
          "blocked objective: two evaluations of the same theta differ")
    dense = objective_and_grad(spec, data, prior)
    vd, gd, okd = dense(theta)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dense(theta)
    torch.cuda.synchronize()
    dense_secs = time.perf_counter() - t0
    data64 = PatientData(data.t.double(), data.y.double(), data.meta, data.mask.double())
    prior64 = hier_gamma_prior(spec, beta_lam=0.01, dtype=torch.float64, device=dev)
    with twins():
        v64, g64, ok64 = objective_and_grad(spec, data64, prior64)(theta.double())
    check(bool(ok) and bool(okd) and bool(ok64), f"blocked/dense/float64 ok: {ok} {okd} {ok64}")
    out = dict(seconds=secs, dense_seconds=dense_secs, value=float(v),
               blocked_vs_dense=rel_errs(v, g, vd, gd),
               blocked_vs_float64=rel_errs(v, g, v64, g64),
               dense_vs_float64=rel_errs(vd, gd, v64, g64))
    print(f"large patient n={LARGE_N} P={LARGE_BLOCKS}: blocked value+gradient "
          f"{secs:.3f} s (dense {dense_secs:.3f} s), bitwise equal on repeat, "
          f"launches {counts}; (value rel, "
          f"grad/scale) blocked vs dense {out['blocked_vs_dense']}, blocked vs float64 "
          f"{out['blocked_vs_float64']}, dense vs float64 {out['dense_vs_float64']}")
    for name in ("blocked_vs_dense", "blocked_vs_float64"):
        v_err, g_err = out[name]
        check(v_err <= VALUE_REL, f"large {name}: value rel err {v_err} > {VALUE_REL}")
        check(g_err <= GRAD_TOL, f"large {name}: grad err {g_err} > {GRAD_TOL} of scale")
    out["diag_blocks"] = {n: diag_block_times(dev, n) for n in (LARGE_N // LARGE_BLOCKS, 4096)}
    torch.cuda.empty_cache()
    return counts, out


def stage_large_cohort():
    """Five ordinary patients (100-400 observations) and one of
    LARGE_TRAIN_N: LARGE_TILE observations of one patient, tiled with each
    copy shifted past the last; `generate` at LARGE_OPT. Returns (cfg_path,
    cfg, recs)."""
    spec = LMCSMSpec(Q, D, R)
    feature_config = os.path.join(ROOT, "examples", "feature_all.json")
    with open(feature_config) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    recs = sample_cohort(SEED + 2, spec, 5, n_clusters=2, n_obs_range=(100, 400))
    big = sample_cohort(SEED + 3, spec, 1, n_clusters=1,
                        n_obs_range=(LARGE_TILE, LARGE_TILE + 1))[0]
    span = float(np.ceil(big.t.max() + 1.0))
    reps = LARGE_TRAIN_N // LARGE_TILE
    big = PatientRecord(
        "syn_large", np.concatenate([big.t + i * span for i in range(reps)]).astype(np.float32),
        np.tile(big.y, reps), np.tile(big.meta, reps))
    recs.append(big)
    write_reference_format_cohort(os.path.join(WORK, "data", "large"), recs, features)
    cfg_path = generate_experiment("large", feature_config, LARGE_OPT, Q=Q, R=R, folds=2,
                                   cohort="large")
    return cfg_path, ExperimentConfig.from_json(cfg_path), recs


def large_train_cli(dev):
    """CLI `train` on the staged cohort through the port's example script
    train_large_patient.sh (the default threshold, --restarts 64, which
    cfg.large_patient_restarts caps for the large patient; a process of its
    own, counted by `run_example`): the large patient trains by row blocks
    after the bucket. Checks one
    `train_large` record (trained, finite loss), every patient's train
    files, the NLML at the trained hypers at or below the best screen
    value (the NLML at train_init_hyp), K3 and K5 launches, and prints the
    peak device memory beside the plan's rule."""
    cfg_path, cfg, recs = stage_large_cohort()
    spec = LMCSMSpec(Q, D, R)
    free = torch.cuda.mem_get_info(0)[0]
    plan = hbm.large_block_plan(LARGE_TRAIN_N, free, Q)
    secs, counts, _, child = run_example(
        "train_large_patient.sh",
        ["bash", os.path.join(EXAMPLES, "train_large_patient.sh"), cfg_path, "8192",
         "--device", dev.type], tuple(KERNELS))
    peak = child["peak_bytes"]
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        large = [json.loads(x) for x in f if '"stage": "train_large"' in x]
    check(len(large) == 1, f"expected one train_large record, got {len(large)}")
    rec = large[0]
    check(rec["trained"] == 1 and np.isfinite(rec["nlml"]) and rec["devices"] == 1
          and rec["n_obs"] == LARGE_TRAIN_N, f"train_large record {rec}")
    check_train_outputs(cfg, recs)
    big = recs[-1]
    p = formats.train_paths(cfg.exp_train_dir, big.pan)
    P, b, n_pad = plan
    padded = pad_observations(big.t, big.y, big.meta, n_pad)
    args = tuple(torch.as_tensor(a, device=dev) for a in padded)
    nlml = large_patient_nlml(spec, P)
    screen_v, _ = nlml(torch.as_tensor(formats.read_double_bin(p["init"]), dtype=torch.float32,
                                       device=dev), *args)
    final_v, ok = nlml(torch.as_tensor(formats.read_double_bin(p["hyp"]), dtype=torch.float32,
                                       device=dev), *args)
    check(bool(ok) and float(final_v) <= float(screen_v),
          f"large patient: NLML {float(final_v)} at the trained hypers above the best "
          f"screen value {float(screen_v)}")
    rule = hbm.large_patient_bytes(n_pad, b, Q)
    out = dict(seconds=secs, train_large_seconds=rec["seconds"], map_loss=rec["nlml"],
               screen_nlml=float(screen_v), trained_nlml=float(final_v), plan=plan,
               peak_bytes=peak, rule_bytes=rule)
    print(f"train (large patient): n={LARGE_TRAIN_N} plan (P, b, n_pad) {plan}; "
          f"{rec['seconds']:.2f} s for it; NLML best screen {float(screen_v):.3f} -> "
          f"trained {float(final_v):.3f} (MAP loss {rec['nlml']:.3f}); peak device "
          f"memory {peak / 2**30:.3f} GiB, the plan's rule {rule / 2**30:.3f} GiB")
    torch.cuda.empty_cache()
    return counts, out


def large_value_and_grad(dev, n):
    """One value+gradient of the blocked objective on a random patient of n
    observations at bench.py's thetas, with the plan from the free memory:
    its seconds, its peak device memory beside utils/hbm.py's rule, and the
    rule's prediction at n = 100,000 on this card."""
    spec = LMCSMSpec(Q, D, R)
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info(0)[0]
    P, b, n_pad = hbm.large_block_plan(n, free, Q)
    data = random_patients(dev, 1, n_pad, 12)
    theta = random_thetas(dev, spec, 1, 12)
    f = large_patient_objective(spec, P, *(x[0] for x in data),
                                prior=hier_gamma_prior(spec, beta_lam=0.01, device=dev))
    reset_launches()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v, g, ok = f(theta)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    counts = read_launches()
    check(bool(ok) and bool(torch.isfinite(v).all()) and bool(torch.isfinite(g).all()),
          f"large value+gradient n={n}: not finite")
    rule = hbm.large_patient_bytes(n_pad, b, Q)
    p100 = hbm.large_block_plan(100000, free, Q)
    rule100 = hbm.large_patient_bytes(p100[2], p100[1], Q)
    # forward n^3/3 and the backward's solves 2 n^3/3 (parallel/mesh.py)
    bound_s = bound(float(n_pad) ** 3, 4.0 * n_pad * (n_pad + b) / 2)[0] / 1e3
    out = dict(n=n, plan=(P, b, n_pad), seconds=secs, bound_seconds=bound_s,
               peak_bytes=peak, rule_bytes=rule, free_bytes=free,
               plan_100000=p100, rule_100000=rule100)
    print(f"large value+gradient n={n} (P, b, n_pad) {(P, b, n_pad)}: {secs:.3f} s "
          f"(bound {bound_s:.3f} s at 67 TFLOP/s fp32); peak {peak / 2**30:.3f} GiB, "
          f"the rule {rule / 2**30:.3f} GiB of {free / 2**30:.2f} GiB free; n=100,000 "
          f"plan {p100}, rule {rule100 / 2**30:.3f} GiB; launches {counts}")
    check(peak <= free, f"large value+gradient n={n}: peak {peak} above free {free}")
    del data, f, v, g
    torch.cuda.empty_cache()
    return counts, out


def free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def counted(name, fn, needs, counts):
    """fn() with the launch counters set to 0 just before and read just
    after into counts[name]; every kernel in `needs` must have launched.
    Returns (fn's result, seconds)."""
    reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts[name] = read_launches()
    for k in needs:
        check(counts[name][k] > 0, f"{name} never launched {k}")
    print(f"{name}: {seconds:.2f} s; launches {counts[name]}")
    return out, seconds


def mesh_large_case(dev):
    """The random patient of MESH_LARGE_N observations, bench.py's theta
    and the hier-gamma prior, from seeds (large_value_and_grad's data)."""
    spec = LMCSMSpec(Q, D, R)
    data = random_patients(dev, 1, MESH_LARGE_N, 12)
    return (spec, tuple(x[0] for x in data), random_thetas(dev, spec, 1, 12),
            hier_gamma_prior(spec, beta_lam=0.01, device=dev))


def mesh_world1(dev, cfg, hmc_draws):
    """The mesh path at world 1 over NCCL on the card (see the module
    docstring, phase 9). Returns (launch counts by path, numbers)."""
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        return _mesh_world1(dev, cfg, hmc_draws)
    finally:
        dist.destroy_process_group()


def _mesh_world1(dev, cfg, hmc_draws):
    mesh = cohort_mesh(dev)
    check((mesh.backend, mesh.world, mesh.rank) == ("nccl", 1, 0), f"mesh {mesh}")
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    counts, secs = {}, {}
    train_needs = ("gram_lmcsm", "chol_solve", "qmat", "gram_lmcsm_bwd")
    tr, secs["train"] = counted("mesh_train", lambda: train_cohort(
        cfg, recs, write=False, device=dev, use_mesh=True), train_needs, counts)
    for r in recs:
        p = formats.train_paths(cfg.exp_train_dir, r.pan)
        got = tr[r.pan]
        same = (got["flag"] == bool(int(formats.read_int_txt(p["flag"])[0]))
                and np.array_equal(got["init_theta"], formats.read_double_bin(p["init"])))
        if got["flag"]:
            same = (same and np.array_equal(got["theta"], formats.read_double_bin(p["hyp"]))
                    and np.array_equal(got["var_state"], formats.read_double_bin(p["var_hyp"])))
        check(same, f"{r.pan}: train_cohort over the mesh differs from `train`'s files")
    print(f"mesh_world1 train_cohort: {len(recs)} patients bitwise equal to `train`'s files")

    index = {pan: i for i, pan in enumerate(cfg.pans())}
    cv = cfg.cv_assign()
    by_mode = {
        "mean_wo_update": (np.asarray([cv[index[r.pan]] for r in recs]),
                           ("gram_lmcsm", "chol_solve", "tri_inv")),
        "mean_w_update": (np.zeros(len(recs), int), tuple(KERNELS)),
    }
    for mode, (folds, needs) in by_mode.items():
        # `test`'s files, read before test_cohort writes its own over them
        files = {r.pan: formats.read_test_result(cfg.exp_test_dir, mode, r.pan)[1] for r in recs}
        te, secs[f"test_{mode}"] = counted(f"mesh_test_{mode}", lambda: test_cohort(
            cfg, recs, folds=folds, modes=(mode,), device=dev, use_mesh=True), needs, counts)
        for r in recs:
            for k in ("pred", "error", "ci", "var"):
                check(np.array_equal(te[r.pan][mode][k], files[r.pan][k]),
                      f"{r.pan}: test_cohort {mode} {k} over the mesh differs from `test`'s")
        print(f"mesh_world1 test_cohort {mode}: bitwise equal to `test`'s files")

    hm, secs["hmc"] = counted("mesh_hmc", lambda: hmc_cohort(
        cfg, recs, num_chains=SAMPLER_BUDGET["chains"], num_warmup=SAMPLER_BUDGET["warmup"],
        num_samples=SAMPLER_BUDGET["samples"], num_leapfrog=SAMPLER_BUDGET["leapfrog"],
        sampler="hmc", write=False, device=dev, use_mesh=True), train_needs, counts)
    for pan, draws in hmc_draws.items():
        check(np.array_equal(hm[pan]["samples"], draws),
              f"{pan}: hmc_cohort over the mesh differs from `hmc --sampler hmc`'s draws")
    print(f"mesh_world1 hmc_cohort: {len(hmc_draws)} patients' draws bitwise equal to "
          f"`hmc --sampler hmc`'s")

    pans, hyps = formats.read_train_kernels(cfg.exp_train_dir, cfg.pans())
    fold_of = np.asarray([cv[index[pan]] for pan in pans], np.int32)
    t0 = time.perf_counter()
    got = population_noise_modes_by_fold(cfg.spec(), mesh, cfg.cv_fold_num)(
        torch.as_tensor(hyps.astype(np.float32), device=dev),
        torch.ones(len(pans), device=dev), torch.as_tensor(fold_of, device=dev))
    got = got.double().cpu().numpy()
    secs["noise_modes"] = time.perf_counter() - t0
    keep = [fold_of != f for f in range(cfg.cv_fold_num)] + [np.ones(len(pans), bool)]
    want = np.stack([np.log(kde_mode_batch(np.exp(hyps[k, :D]).T, weighted=True, device=dev))
                     for k in keep])
    noise_rel = float(np.max(np.abs(got - want) / np.abs(want)))
    print(f"mesh_world1 noise modes ({cfg.cv_fold_num} folds + all, {len(pans)} patients) "
          f"over NCCL in {secs['noise_modes']:.3f} s: max relative difference "
          f"{noise_rel:.3e} from the host float64 KDE (tol {MESH_NOISE_REL:g})")
    check(noise_rel <= MESH_NOISE_REL, f"noise modes {noise_rel} > {MESH_NOISE_REL}")

    spec, args, theta, prior = mesh_large_case(dev)
    v1, g1, ok1 = large_patient_objective(spec, MESH_LARGE_BLOCKS, *args, prior=prior)(theta)
    (vm, gm, okm), secs["large"] = counted("mesh_large", lambda: large_patient_objective(
        spec, MESH_LARGE_BLOCKS, *args, prior=prior, mesh=mesh)(theta),
        ("chol_solve", "tri_inv"), counts)
    check(bool(ok1) and bool(okm) and torch.equal(v1, vm) and torch.equal(g1, gm),
          "the row-sharded value+gradient at world 1 differs from the one-device blocked path")
    np.savez(os.path.join(WORK, "mesh_large_w1.npz"), value=vm.cpu().numpy(),
             grad=gm.cpu().numpy())
    print(f"mesh_world1 large n={MESH_LARGE_N} P={MESH_LARGE_BLOCKS}: value+gradient "
          f"bitwise equal to the one-device blocked path")
    del args, v1, g1, vm, gm
    torch.cuda.empty_cache()
    return counts, dict(seconds=secs, noise_rel_max=noise_rel)


def torchrun(name, args):
    """RANKS_SHARED ranks of this script (`--rank ARGS`) on the one card,
    started by `torchrun --standalone` in a session of their own, which is
    killed at RANK_TIMEOUT; the log goes to .chip_smoke/{name}.log. Returns
    (standard output, seconds)."""
    torch.cuda.empty_cache()
    log_path = os.path.join(WORK, f"{name}.log")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={RANKS_SHARED}", os.path.abspath(__file__), "--rank", *args]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=RANK_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
    seconds = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(out + err)
    check(proc.returncode == 0, f"{name}: torchrun exited {proc.returncode} after "
          f"{seconds:.0f} s; the end of its log:\n{(out + err)[-3000:]}")
    print(f"{name}: {RANKS_SHARED} ranks on one card over gloo in {seconds:.2f} s "
          f"(start-up included)")
    return out, seconds


def rank_counts(out_dir, kind, world=RANKS_SHARED):
    """Every rank's launch counts and numbers of a `--rank KIND` run, and
    their sums."""
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"{kind}.rank{r}.json")) as f:
            ranks.append(json.load(f))
    total = {k: sum(x["counts"][k] for x in ranks) for k in KERNELS}
    return ranks, total


def mesh_shared_card(dev, run_cfg):
    """The CLI `run` at full width, two folds, over two ranks sharing the
    card (gloo), against run_full_width's files (phase 9). Returns
    (launch counts, numbers)."""
    cfg_path = generate_experiment(
        "mesh", os.path.join(ROOT, "examples", "feature_all.json"), TRAIN_OPT,
        Q=Q, R=R, folds=2)
    cfg = ExperimentConfig.from_json(cfg_path)
    out_dir = os.path.join(WORK, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    stdout, seconds = torchrun("mesh_shared_card", [
        "cli", out_dir, "run", "--cfg", cfg_path, "--device", dev.type, "--dist-backend", "gloo"])
    ranks, counts = rank_counts(out_dir, "cli")
    for k in KERNELS:
        check(counts[k] > 0, f"mesh_shared_card never launched {k}")
    summary = json.loads([x for x in stdout.splitlines() if x.startswith("{")][-1])
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
        for k in ("mae", "ci_ratio", "nll"):
            check(np.isfinite(summary[mode][k]), f"mesh_shared_card: {mode} {k} not finite")
    slices = check_rank_slices(cfg, dev, out_dir)
    names = sorted(x for x in os.listdir(run_cfg.exp_train_dir)
                   if x.split("_")[1] in ("hyp", "init", "var", "flag", "num"))
    check(names == sorted(x for x in os.listdir(cfg.exp_train_dir) if x in names)
          and len(names) == 5 * len(recs), "mesh_shared_card: train files missing")
    differ, worst = [], 0.0
    for name in names:
        want = os.path.join(run_cfg.exp_train_dir, name)
        got = os.path.join(cfg.exp_train_dir, name)
        with open(want, "rb") as a, open(got, "rb") as b:
            if a.read() == b.read():
                continue
        differ.append(name)
        if name.endswith(".bin"):
            w, g = formats.read_double_bin(want), formats.read_double_bin(got)
            worst = max(worst, float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30)))
    # the train path is not batch-invariant on the card (ROADMAP.md §C): a
    # rank trains half a bucket, so its float32 trajectories leave the
    # full bucket's; check_rank_slices holds the run to one device
    # running the ranks' slices, bitwise
    print(f"mesh_shared_card: {len(names) - len(differ)} of {len(names)} train files bitwise "
          f"equal to run (full width)'s, which trains whole buckets; largest difference "
          f"over the scale {worst:.3e} in {differ[:3]}")
    noise_rel = 0.0
    host_dir = os.path.join(WORK, "mesh_host_kernels")
    for fold in (-1, 0, 1):
        kernel_clustering_fold(cfg.spec(), cfg.exp_train_dir, host_dir, cfg.pans(),
                               cfg.cv_assign(), fold, algorithm="gmm", seed=cfg.random_seed,
                               device=dev)
        want, wq = formats.read_mode_kernel(host_dir, fold, "gmm")
        got, gq = formats.read_mode_kernel(cfg.exp_kernel_dir, fold, "gmm")
        check(gq == wq and np.array_equal(got[D:], want[D:]),
              f"mesh_shared_card: fold {fold}'s mode kernel differs beyond its noise block "
              f"from the host path's on the run's own train files")
        noise_rel = max(noise_rel, float(np.max(np.abs(got[:D] - want[:D]) / np.abs(want[:D]))))
    print(f"mesh_shared_card: mode kernels equal to the host path's (`kernclust` on the "
          f"run's train files) but for the noise block, max relative difference "
          f"{noise_rel:.3e} (tol {MESH_NOISE_REL:g}); summary {json.dumps(summary)}")
    check(noise_rel <= MESH_NOISE_REL, f"mesh_shared_card: noise modes {noise_rel}")
    with open(os.path.join(cfg.exp_log_dir, "metrics.p1.jsonl")) as f:
        check(all(json.loads(x)["process"] == 1 for x in f), "metrics.p1.jsonl: process")
    return counts, dict(seconds=seconds, summary=summary, rank_slices=slices,
                        files_differ_from_whole_buckets=len(differ),
                        whole_bucket_worst=worst, noise_rel_max=noise_rel,
                        stages=run_stage_seconds(cfg))


def check_rank_slices(cfg, dev, out_dir):
    """The shared-card run's train stage against this one device: every
    bucket as train_cohort packs it, padded to a multiple of the world;
    each rank's recorded slice (`--rank cli` records every
    train_one_patient call of parallel/mesh.py) must be that bucket's rows
    r m .. (r + 1) m, one device must train it to the rank's bits, and the
    train files rank 0 wrote must hold those bits for the real rows."""
    spec = cfg.spec()
    recs = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    inits = random_inits(cfg.random_seed, spec, cfg.bounds(), cfg.random_init_num).to(dev)
    kw = dict(prior_mode=cfg.prior_index, eta=cfg.eta, beta_lam=cfg.beta_lam,
              top_iters=cfg.top_iteration_num, sub_opt_iter=cfg.iteration_num_per_update)
    batches = pack_patients(recs, max_batch=runner.TRAIN_MAX_BATCH, device=dev)
    ranks = [np.load(os.path.join(out_dir, f"train.rank{r}.npz")) for r in range(RANKS_SHARED)]
    check(all(int(z["calls"]) == len(batches) for z in ranks),
          f"mesh_shared_card: {[int(z['calls']) for z in ranks]} train calls for "
          f"{len(batches)} buckets")
    t0 = time.perf_counter()
    for k, b in enumerate(batches):
        B = len(b)
        m = round_up(B, RANKS_SHARED) // RANKS_SHARED
        padded = pad_batch_to(runner.batch_data(b, dev), m * RANKS_SHARED)
        for r, z in enumerate(ranks):
            data = PatientData(*(x[r * m:(r + 1) * m] for x in padded))
            for name, x in zip(PatientData._fields, data):
                check(np.array_equal(z[f"c{k}_{name}"], x.cpu().numpy()),
                      f"bucket {k} rank {r}: the rank's {name} is not its slice")
            res = train_one_patient(spec, data, inits, **kw)
            got = dict(theta=res.theta, init_theta=res.init_theta, flag=res.flag,
                       var=res.var_state.flatten())
            for name, x in got.items():
                check(np.array_equal(z[f"c{k}_{name}"], x.cpu().numpy()),
                      f"bucket {k} rank {r}: one device trains the slice to other {name}")
            for i in range(min(m, B - r * m)):
                p = formats.train_paths(cfg.exp_train_dir, b.pans[r * m + i])
                flag = bool(res.flag[i])
                same = (flag == bool(int(formats.read_int_txt(p["flag"])[0])) and np.array_equal(
                    formats.read_double_bin(p["init"]), res.init_theta[i].double().cpu().numpy()))
                if flag:
                    same = same and np.array_equal(
                        formats.read_double_bin(p["hyp"]), res.theta[i].double().cpu().numpy()
                    ) and np.array_equal(formats.read_double_bin(p["var_hyp"]),
                                         got["var"][i].double().cpu().numpy())
                check(same, f"{b.pans[r * m + i]}: rank 0's train files differ from rank "
                      f"{r}'s slice")
    seconds = time.perf_counter() - t0
    print(f"mesh_shared_card: {len(batches)} buckets x {RANKS_SHARED} ranks' slices: the "
          f"inputs are the buckets' rows, one device trains each to the rank's bits, and "
          f"rank 0's {len(recs)} patients' train files hold them ({seconds:.1f} s)")
    return dict(buckets=len(batches), seconds=seconds)


def large_sharded_shared_card(dev):
    """mesh_world1's row-sharded value+gradient over two ranks sharing the
    card (gloo), two row blocks a rank (phase 9). Returns (launch counts,
    numbers)."""
    out_dir = os.path.join(WORK, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    _, seconds = torchrun("large_sharded_shared_card", ["large", out_dir, dev.type])
    ranks, counts = rank_counts(out_dir, "large")
    check(counts["chol_solve"] > 0 and counts["tri_inv"] > 0,
          f"large_sharded_shared_card: K3/K5 launches {counts}")
    w1 = np.load(os.path.join(WORK, "mesh_large_w1.npz"))
    free = torch.cuda.mem_get_info(0)[0]
    plan = hbm.large_block_plan(MESH_LARGE_N, free, Q, world=RANKS_SHARED)
    b = MESH_LARGE_N // MESH_LARGE_BLOCKS
    rule = hbm.large_patient_bytes(MESH_LARGE_N, b, Q, world=RANKS_SHARED)
    out = dict(seconds=seconds, plan_world2=plan, rule_bytes=rule, ranks=[])
    for r, rk in enumerate(ranks):
        z = np.load(os.path.join(out_dir, f"large.rank{r}.npz"))
        v_rel = float(np.abs(z["value"] - w1["value"]).max() / np.abs(w1["value"]).max())
        g_err = float(np.abs(z["grad"] - w1["grad"]).max() / np.abs(w1["grad"]).max())
        bitwise = bool(np.array_equal(z["value"], w1["value"])
                       and np.array_equal(z["grad"], w1["grad"]))
        print(f"large_sharded_shared_card rank {r}: value+gradient {rk['seconds']:.3f} s; "
              f"value rel diff {v_rel:.3e} (tol {MESH_VALUE_REL:g}), gradient diff over "
              f"the scale {g_err:.3e} (tol {MESH_GRAD_TOL:g}), bitwise equal to one rank's: "
              f"{bitwise} (the tile cotangents are summed in one rank's order); peak device memory "
              f"{rk['peak_bytes'] / 2**30:.3f} GiB against the rule at world 2 "
              f"{rule / 2**30:.3f} GiB (P={MESH_LARGE_BLOCKS}, b={b}; "
              f"large_block_plan(world=2) at {free / 2**30:.1f} GiB free: {plan})")
        check(bool(rk["ok"]) and v_rel <= MESH_VALUE_REL and g_err <= MESH_GRAD_TOL,
              f"large_sharded_shared_card rank {r}: value {v_rel}, gradient {g_err}")
        out["ranks"].append(dict(rk, value_rel=v_rel, grad_err=g_err, bitwise=bitwise))
    return counts, out


def sampler_shared_card(dev, cfg, hmc_draws):
    """CLI `hmc` (hmc at SAMPLER_BUDGET) over two ranks sharing the card
    (gloo) on a copy of the trained experiment's MAP files. Each rank
    records every sampler call of its slice (`--rank hmc`): one device
    sampling each recorded slice with the same streams must give the
    rank's draws bitwise; the slices' keys must be the patients' cohort
    indices (padding rows PAD_KEY), every trained patient in exactly one;
    rank 0's files must hold the recorded draws. The largest difference
    from phase 7's whole-bucket draws on one device is printed, not
    checked: the potential's reductions are not batch-invariant on the
    card (ROADMAP.md §C, C3). Returns (launch counts, numbers)."""
    cfg_path = generate_experiment(
        "smp", os.path.join(ROOT, "examples", "feature_all.json"), TRAIN_OPT,
        Q=Q, R=R, folds=cfg.cv_fold_num)
    new = ExperimentConfig.from_json(cfg_path)
    for name in os.listdir(cfg.exp_train_dir):
        if name.split("_")[1] in ("hyp", "init", "var", "flag", "num"):
            shutil.copy(os.path.join(cfg.exp_train_dir, name), new.exp_train_dir)
    out_dir = os.path.join(WORK, "ranks")
    os.makedirs(out_dir, exist_ok=True)
    _, seconds = torchrun("sampler_shared_card", [
        "hmc", out_dir, "hmc", "--cfg", cfg_path, "--device", dev.type, "--dist-backend",
        "gloo", *SAMPLER_CLI, "--sampler", "hmc"])
    ranks, counts = rank_counts(out_dir, "hmc")
    for k in ("gram_lmcsm", "gram_lmcsm_bwd", "chol_solve", "qmat"):
        check(counts[k] > 0, f"sampler_shared_card never launched {k}")
    files = check_sampler_outputs(new, "hmc")
    spec = new.spec()
    prior = hier_gamma_prior(spec, beta_lam=new.beta_lam, device=dev)
    index = {p: i for i, p in enumerate(new.pans())}
    by_key, calls = {}, 0
    t0 = time.perf_counter()
    for r, rk in enumerate(ranks):
        kw = dict(rk["hmc_kwargs"])
        seed = kw.pop("seed")
        z = np.load(os.path.join(out_dir, f"hmc.rank{r}.npz"))
        for k in range(int(z["calls"])):
            data = PatientData(*(torch.as_tensor(z[f"c{k}_{f}"], device=dev)
                                 for f in PatientData._fields))
            key = torch.as_tensor(z[f"c{k}_key"], device=dev)
            res = hmc_patient(spec, data, torch.as_tensor(z[f"c{k}_theta0"], device=dev),
                              st.Streams(seed, key, torch.zeros_like(key)), prior=prior, **kw)
            got = z[f"c{k}_samples"]
            check(np.array_equal(res.samples.cpu().numpy(), got),
                  f"sampler_shared_card: one device samples rank {r}'s slice {k} to other bits")
            for i, key_i in enumerate(z[f"c{k}_key"].tolist()):
                if key_i != st.PAD_KEY:
                    check(key_i not in by_key, f"patient key {key_i} sampled twice")
                    by_key[key_i] = got[i]
            calls += 1
    check(sorted(by_key) == sorted(index[p] for p in files),
          "sampler_shared_card: the slices' keys are not the trained patients' cohort indices")
    for pan, draws in files.items():
        check(np.array_equal(draws, by_key[index[pan]]),
              f"{pan}: rank 0's file differs from the rank's recorded draws")
    resample_s = time.perf_counter() - t0
    worst, same = 0.0, 0
    for pan, draws in files.items():
        ref = hmc_draws[pan]
        same += int(np.array_equal(draws, ref))
        worst = max(worst, float(np.abs(draws - ref).max() / np.abs(ref).max()))
    print(f"sampler_shared_card: {calls} slices over {RANKS_SHARED} ranks, each sampled to the "
          f"rank's bits by one device with the same streams ({resample_s:.1f} s); {len(files)} "
          f"patients keyed by cohort index; against the whole-bucket draws on one device: "
          f"{same} of {len(files)} bitwise equal, largest difference over the scale "
          f"{worst:.3e} (not checked: C3)")
    return counts, dict(seconds=seconds, slices=calls, patients=len(files),
                        whole_bucket_equal=same, whole_bucket_worst=worst,
                        resample_seconds=resample_s)


def examples(dev, run_s, large_s):
    """The port's example entry points (medgp_tpu_torch/examples/) on the
    card, each a process of its own: run_pipeline.sh and
    train_large_patient.sh ran in phases 6 and 8 (`run_s`, `large_s`: their
    seconds and launches); here launch_pod.py under `torchrun --standalone
    --nproc-per-node 1` runs `run` on the first 16 patients of the staged
    cohort (two folds), every output checked, and gen_example.sh writes
    the canonical experiment over etl_to_run's cohort, without running it:
    its exp_setup.json must hold LMC-SM Q=5, R=8, D=24, the hier-gamma
    prior, eta and beta_lambda 0.01, 10 folds over every admission and
    opt_prior2.json's budgets. Returns (launch counts, numbers)."""
    synth = ExperimentConfig.from_json(os.path.join(
        WORK, "exp", f"smoke_k7_q{Q}_r{R}_p2_e0.01", "config", "exp_setup.json"))
    recs = load_cohort(synth.data_dir, synth.pans(), synth.feature_list)[:16]
    write_reference_format_cohort(os.path.join(WORK, "data", "pod"), recs, synth.feature_list)
    cfg_path = generate_experiment(
        "pod", os.path.join(ROOT, "examples", "feature_all.json"), TRAIN_OPT,
        Q=Q, R=R, folds=2, cohort="pod")
    cfg = ExperimentConfig.from_json(cfg_path)
    pod_s, counts, stdout, _ = run_example(
        "launch_pod.py", [sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node=1", os.path.abspath(__file__), "--rank", "exec",
                          "{out}", os.path.join(EXAMPLES, "launch_pod.py"), "--cfg",
                          cfg_path, "--device", dev.type], tuple(KERNELS))
    summary = run_summary("launch_pod.py", stdout)
    check_train_outputs(cfg, recs)
    check_mode_kernels(cfg, (-1, 0, 1))
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    print(f"launch_pod.py: stage seconds {json.dumps(run_stage_seconds(cfg))}; summary "
          f"{json.dumps(summary)}")

    gen_root = os.path.join(WORK, "gen_example")
    os.makedirs(os.path.join(gen_root, "data"), exist_ok=True)
    os.symlink(os.path.join(WORK, "data", "mimic"),
               os.path.join(gen_root, "data", "heart_failure"))
    gen_s, _, _, _ = run_example(
        "gen_example.sh", ["bash", os.path.join(EXAMPLES, "gen_example.sh")], (),
        env=dict(DATA_ROOT=os.path.join(gen_root, "data"),
                 EXP_ROOT=os.path.join(gen_root, "exp"), PYTHON=sys.executable))
    gen = ExperimentConfig.from_json(os.path.join(
        gen_root, "exp", "jmlr_k7_q5_r8_p2_e0.01", "config", "exp_setup.json"))
    with open(os.path.join(EXAMPLES, "opt_prior2.json")) as f:
        opt = json.load(f)
    got = dict(kernel=gen.kernel, prior=gen.prior, Q=gen.Q, R=gen.R, D=gen.D, eta=gen.eta,
               beta_lam=gen.beta_lam, folds=gen.cv_fold_num,
               **{k: getattr(gen, k) for k in opt})
    want = dict(kernel="LMC-SM", prior="hier-gamma", Q=5, R=8, D=D, eta=0.01, beta_lam=0.01,
                folds=10, **opt)
    check(got == want, f"gen_example.sh wrote {got}, not {want}")
    cv = gen.cv_assign()
    check(len(cv) == len(gen.pans()) and set(cv.tolist()) == set(range(10)),
          f"gen_example.sh: {len(cv)} CV entries over {len(gen.pans())} admissions")
    print(f"gen_example.sh: {os.path.relpath(gen.exp_top_dir, WORK)} over {len(gen.pans())} "
          f"admissions in {gen_s:.2f} s: {json.dumps(got)}")
    return counts, dict(
        run_pipeline=run_s, train_large_patient=large_s,
        launch_pod=dict(seconds=pod_s, patients=len(recs), summary=summary),
        gen_example=dict(seconds=gen_s, admissions=len(gen.pans())),
    )


def rank_main(argv):
    """One rank of a shared-card phase, under torchrun (`--rank cli DIR
    ARGS...`: the CLI with ARGS, every train_one_patient call of
    parallel/mesh.py recorded to DIR/train.rank{r}.npz; `--rank hmc DIR
    ARGS...`: the CLI with ARGS, every hmc_patient call of the runner (the
    rank's slice, its streams and draws) recorded to DIR/hmc.rank{r}.npz;
    `--rank large DIR DEVICE`: the row-sharded
    value+gradient of mesh_large_case over the ranks, gloo, on this rank's
    DEVICE; `--rank exec DIR -m MODULE ARGS...` or `--rank exec DIR SCRIPT
    ARGS...`: the module's main() or the script as `python` would run it,
    an example entry point's process (run_example), with its seconds and
    peak device memory, RANK 0 outside torchrun); writes
    DIR/{kind}.rank{r}.json with its launch counts, also when the run
    raises, whose exception passes on as it is."""
    kind, out_dir = argv[0], argv[1]
    rank = int(os.environ.get("RANK", "0"))
    result = {}
    reset_launches()
    t0 = time.perf_counter()
    try:
        rank_run(kind, out_dir, rank, argv[2:], result)
    finally:
        if kind == "exec":
            result.update(seconds=time.perf_counter() - t0,
                          peak_bytes=torch.cuda.max_memory_allocated()
                          if torch.cuda.is_initialized() else 0)
        with open(os.path.join(out_dir, f"{kind}.rank{rank}.json"), "w") as f:
            json.dump(dict(counts=read_launches(), **result), f)
    return 0


def rank_run(kind, out_dir, rank, rest, result):
    """rank_main's run of one kind; its numbers go into `result`."""
    if kind == "exec":
        if rest[0] == "-m":
            sys.argv = list(rest[1:])
            importlib.import_module(rest[1]).main()
        else:
            sys.argv = list(rest)
            runpy.run_path(rest[0], run_name="__main__")
    elif kind == "cli":
        own, calls = mesh_module.train_one_patient, []

        def recording(spec, data, inits, **kw):
            res = own(spec, data, inits, **kw)
            calls.append(dict(zip(PatientData._fields, data), theta=res.theta,
                              init_theta=res.init_theta, flag=res.flag,
                              var=res.var_state.flatten()))
            return res

        mesh_module.train_one_patient = recording
        try:
            cli(rest)
        finally:
            mesh_module.train_one_patient = own
        np.savez(os.path.join(out_dir, f"train.rank{rank}.npz"), calls=len(calls),
                 **{f"c{k}_{name}": x.cpu().numpy() for k, c in enumerate(calls)
                    for name, x in c.items()})
    elif kind == "hmc":
        own, calls, kwargs = runner.hmc_patient, [], {}

        def recording(spec, data, theta0, streams, prior=None, **kw):
            res = own(spec, data, theta0, streams, prior=prior, **kw)
            calls.append(dict(zip(PatientData._fields, data), theta0=theta0,
                              key=streams.key, samples=res.samples))
            kwargs.update(kw, seed=streams.seed)
            return res

        runner.hmc_patient = recording
        try:
            cli(rest)
        finally:
            runner.hmc_patient = own
        np.savez(os.path.join(out_dir, f"hmc.rank{rank}.npz"), calls=len(calls),
                 **{f"c{k}_{name}": x.cpu().numpy() for k, c in enumerate(calls)
                    for name, x in c.items()})
        result["hmc_kwargs"] = kwargs
    else:
        dev = rank_device(rest[0])
        init_distributed(backend="gloo", device=dev)
        try:
            mesh = cohort_mesh(dev)
            spec, args, theta, prior = mesh_large_case(dev)
            f = large_patient_objective(spec, MESH_LARGE_BLOCKS, *args, prior=prior, mesh=mesh)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            v, g, ok = f(theta)
            torch.cuda.synchronize()
            result.update(seconds=time.perf_counter() - t0, ok=bool(ok),
                          peak_bytes=torch.cuda.max_memory_allocated() - base)
            np.savez(os.path.join(out_dir, f"large.rank{rank}.npz"), value=v.cpu().numpy(),
                     grad=g.cpu().numpy())
        finally:
            dist.destroy_process_group()


def synthetic_mimic(out_dir, seed):
    """Write the ETL phase's synthetic MIMIC-III tables (ETL_ADMISSIONS;
    ETL_EVENTS per signal; ETL_NOISE) under `out_dir` and return what the
    ETL must make of them, worked out here from the rows alone: the
    admission ids of cohort_hadm_match.txt, every pass-1 admission's
    feature files as bytes, each signal's (mean, std) over the pass-1
    values (np.mean, np.std), the ids whose files stay without a listing
    and those with no files, and the rows of each event table."""
    lo, hi = ETL_EVENTS
    rng = np.random.default_rng(seed)
    signals = [(idx, item, lb, ub, "chart")
               for (idx, _, item), (lb, ub) in zip(VITAL_ITEMS, VITAL_BOUNDS)]
    signals += [(idx, item, 0.0, None, "lab") for idx, _, item in LAB_ITEMS]
    kinds = np.asarray([k for k, c in ETL_ADMISSIONS.items() for _ in range(c)])
    n_adm = len(kinds)
    hadm = rng.choice(np.arange(100000, 200000), n_adm, replace=False)
    admit = (np.datetime64("2150-01-01T00:00:00", "s")
             + rng.integers(0, 3650 * 86400, n_adm).astype("timedelta64[s]"))
    with_events = (kinds != "other") | (np.arange(n_adm) % 2 == 0)
    rows = {"chart": [], "lab": []}  # (admission, item, offset s, value)
    kept = 0  # the pass-1 admissions' rows in 0-72 h with a value in bounds
    for a in np.flatnonzero(with_events):
        kind = kinds[a]
        special = int(rng.integers(len(signals)))
        level, period = rng.normal(), rng.uniform(12, 72)
        density = rng.uniform(lo, hi)  # events per signal, about
        for s, (idx, item, lb, ub, table) in enumerate(signals):
            mean, spread = ETL_VALUES[s]
            short = kind in ("fail_pass1", "fail_pass2") and s == special
            k = 3 if short else int(np.clip(np.rint(density + rng.normal()), lo, hi))
            offs = np.unique(rng.integers(60, 72 * 3600, k + 8))[: k - 1]
            offs = np.concatenate([offs, offs[:1]])  # one repeated CHARTTIME
            vals = mean * (1 + spread * (0.5 * level + 0.5 * np.sin(
                2 * np.pi * offs / 3600 / period) + 0.5 * rng.normal(size=k)))
            vals = np.round(np.clip(vals, (lb or 0.0) + 0.01, ub or np.inf), 2)
            pre = rng.integers(-48 * 3600, -60, 4 if kind == "fail_pass2" and short else 1)
            if kind == "fail_pass1" and short:
                pre = pre[:0]
            edge_t = rng.integers(60, 72 * 3600, 2)
            oob = ub + 50.0 if ub is not None else -1.0
            kept += k if kind in ("ok", "fail_pass2") else 0
            add = rows[table].append
            for o, v in zip(offs, vals):
                add((a, item, int(o), float(v)))
            for o in pre:
                add((a, item, int(o), float(np.round(mean, 2))))
            add((a, item, int(edge_t[0]), oob))
            add((a, item, int(edge_t[1]), np.nan))
    # outpatient labs (no HADM_ID), then the other ITEMIDs
    ours = {item for _, item, *_ in signals}
    for _ in range(1000):
        rows["lab"].append((-1, LAB_ITEMS[int(rng.integers(len(LAB_ITEMS)))][2],
                            int(rng.integers(-1e6, 1e6)), float(rng.uniform(1, 9))))
    n_noise = ETL_NOISE * kept
    for table, share, base in (("chart", 1 - ETL_LAB_SHARE, 220000), ("lab", ETL_LAB_SHARE, 50800)):
        m = int(n_noise * share)
        items = base + rng.integers(0, 700, m)
        items = np.where(np.isin(items, list(ours)), base + 999, items)
        adm = rng.integers(-1, n_adm, m)
        offs = rng.integers(-48 * 3600, 96 * 3600, m)
        vals = np.round(rng.uniform(0, 200, m), 2)
        rows[table] += list(zip(adm.tolist(), items.tolist(), offs.tolist(), vals.tolist()))

    # the tables, event rows in a shuffled order
    os.makedirs(out_dir, exist_ok=True)
    code = {"ok": "4280", "dead": "42823", "no_chart": "42833", "fail_pass1": "42822",
            "fail_pass2": "4281", "other": "4019"}
    subject = rng.integers(10000, 99999, n_adm)

    def write(name, header, body):
        with gzip.open(os.path.join(out_dir, f"{name}.csv.gz"), "wt", compresslevel=1,
                       newline="") as f:
            w = csv.writer(f)
            w.writerow(header)
            w.writerows(body)

    diag = [(subject[a], hadm[a], 1, code[kinds[a]]) for a in range(n_adm)]
    diag += [(subject[a], hadm[a], 2, c) for a in range(n_adm) for c in ("41401", "V4581")]
    write("DIAGNOSES_ICD", ["ROW_ID", "SUBJECT_ID", "HADM_ID", "SEQ_NUM", "ICD9_CODE"],
          ((i + 1, *r) for i, r in enumerate(diag)))
    admit_s = np.char.replace(np.datetime_as_string(admit, unit="s"), "T", " ")
    write("ADMISSIONS", [
        "ROW_ID", "SUBJECT_ID", "HADM_ID", "ADMITTIME", "DISCHTIME", "DEATHTIME",
        "ADMISSION_TYPE", "DIAGNOSIS", "DISCHARGE_LOCATION", "HOSPITAL_EXPIRE_FLAG",
        "HAS_CHARTEVENTS_DATA"], (
        (a + 1, subject[a], hadm[a], admit_s[a], "", "", "EMERGENCY",
         "CONGESTIVE HEART FAILURE, ACUTE" if kinds[a] != "other" else "CHEST PAIN",
         "DEAD/EXPIRED" if kinds[a] == "dead" else "HOME", int(kinds[a] == "dead"),
         int(kinds[a] != "no_chart")) for a in rng.permutation(n_adm)))
    tables = {}
    for table in ("chart", "lab"):
        r = rows[table]
        order = rng.permutation(len(r))
        a = np.asarray([r[i][0] for i in order])
        item = np.asarray([r[i][1] for i in order])
        off = np.asarray([r[i][2] for i in order])
        val = np.asarray([r[i][3] for i in order], np.float64)
        when = np.char.replace(np.datetime_as_string(
            admit[np.maximum(a, 0)] + off.astype("timedelta64[s]"), unit="s"), "T", " ")
        hadm_s = np.where(a >= 0, hadm[np.maximum(a, 0)].astype(str), "")
        vnum = ["" if v != v else repr(v) for v in val.tolist()]
        tables[table] = (a, item, off, val)
        if table == "chart":
            write("CHARTEVENTS", [
                "ROW_ID", "SUBJECT_ID", "HADM_ID", "ICUSTAY_ID", "ITEMID", "CHARTTIME",
                "STORETIME", "CGID", "VALUE", "VALUENUM", "VALUEUOM", "WARNING", "ERROR",
                "RESULTSTATUS", "STOPPED"], (
                (i + 1, subject[max(x, 0)], h, 200000 + max(x, 0), it, w, w, 15000,
                 v, v, "units", 0, 0, "", "")
                for i, (x, h, it, w, v) in enumerate(zip(
                    a.tolist(), hadm_s.tolist(), item.tolist(), when.tolist(), vnum))))
        else:
            write("LABEVENTS", [
                "ROW_ID", "SUBJECT_ID", "HADM_ID", "ITEMID", "CHARTTIME", "VALUE",
                "VALUENUM", "VALUEUOM", "FLAG"], (
                (i + 1, subject[max(x, 0)], h, it, w, v, v, "mg/dL", "")
                for i, (x, h, it, w, v) in enumerate(zip(
                    a.tolist(), hadm_s.tolist(), item.tolist(), when.tolist(), vnum))))

    # what the ETL must make of them
    first = sorted(np.flatnonzero((kinds == "ok") | (kinds == "fail_pass2")),
                   key=lambda a: hadm[a])
    stats, files = {}, {}
    ours_rows = {  # the pass-1 admissions' rows of the 24 signals, in table order
        table: tuple(x[sel] for x in cols) for table, cols in tables.items()
        for sel in [np.flatnonzero(np.isin(cols[0], first) & np.isin(cols[1], list(ours)))]
    }
    for idx, item, lb, ub, table in signals:
        a, it, off, val = ours_rows[table]
        pooled = []
        for x in first:
            sel = np.flatnonzero((a == x) & (it == item))
            v = val[sel]
            ok = ~np.isnan(v) & (v > lb) & ((v <= ub) if ub is not None else True)
            pooled.append(v[ok])
            keep = sel[ok & (off[sel] > 0)]
            keep = keep[np.argsort(off[keep], kind="stable")]
            t = off[keep].astype(np.float64).astype(np.float32) / np.float32(3600)
            body = np.stack([t, val[keep].astype(np.float32)], 1).ravel()
            files[(f"hadm_{hadm[x]}", idx)] = "".join(
                "%6.6f\n" % u for u in [float(len(keep)), *body.astype(np.float64).tolist()]
            ).encode()
        allv = np.concatenate(pooled)
        stats[idx] = (float(np.mean(allv)), float(np.std(allv)))
    pan = lambda kind: sorted(f"hadm_{hadm[a]}" for a in np.flatnonzero(kinds == kind))
    return dict(
        pans=[f"hadm_{hadm[a]}" for a in first if kinds[a] == "ok"], files=files,
        stats=stats, unlisted=pan("fail_pass2"),
        absent=[p for k in ("dead", "no_chart", "fail_pass1", "other") for p in pan(k)],
        rows={t: len(v[0]) for t, v in tables.items()},
    )


def check_etl(out_dir, pans, truth):
    """The ETL's output against what synthetic_mimic worked out: the id
    list, every feature file byte for byte, the stats within 1e-12
    relative (and whether bitwise), the files of the admissions that fail
    the second pass, and none of the others'."""
    check(pans == truth["pans"], f"ETL: {len(pans)} admissions, expected {len(truth['pans'])}")
    with open(os.path.join(out_dir, "cohort_hadm_match.txt")) as f:
        check(f.read().split() == truth["pans"], "ETL: cohort_hadm_match.txt")
    for (pan, idx), want in truth["files"].items():
        with open(os.path.join(out_dir, pan, f"feature{idx}.txt"), "rb") as f:
            check(f.read() == want, f"ETL: {pan}/feature{idx}.txt differs")
    rel, bitwise = 0.0, True
    for idx, want in truth["stats"].items():
        got = formats.read_feature_stat(os.path.join(out_dir, f"feature{idx}_stat.bin"))
        rel = max(rel, *(abs(g - w) / abs(w) for g, w in zip(got, want)))
        bitwise &= tuple(got) == tuple(want)
    check(rel <= 1e-12, f"ETL: stats {rel:.3e} from numpy's (relative)")
    for pan in truth["unlisted"]:
        check(os.path.isdir(os.path.join(out_dir, pan)), f"ETL: no files of {pan}")
    for pan in truth["absent"]:
        check(not os.path.exists(os.path.join(out_dir, pan)), f"ETL: files of {pan}")
    print(f"ETL output: {len(pans)} admissions listed, {len(truth['files'])} feature files "
          f"byte-equal to the generator's, {len(truth['unlisted'])} unlisted with files, "
          f"{len(truth['absent'])} without; stats {rel:.3e} from numpy's "
          f"({'bitwise' if bitwise else 'not bitwise'})")
    return rel, bitwise


def fastkernel_vs_k1(cfg, recs, dev):
    """K1's masked gram at full width (n = 512, Q = 5, D = 24, R = 8) on
    ETL_K1_PATIENTS trained patients of the n = 512 bucket, with their
    thetas from the train files, against fastkernel.gram_lmcsm in float64
    on the same (float32) times: every valid entry within GRAM_ATOL +
    GRAM_RTOL |ref|."""
    spec = LMCSMSpec(Q, D, R)
    trained = dict(zip(*formats.read_train_kernels(cfg.exp_train_dir, [r.pan for r in recs])))
    pick = [r for r in recs if 256 < r.n_obs <= 512 and r.pan in trained][:ETL_K1_PATIENTS]
    check(len(pick) == ETL_K1_PATIENTS, f"only {len(pick)} trained patients at n = 512")
    n = 512
    t = np.zeros((len(pick), n), np.float32)
    meta = np.zeros((len(pick), n), np.int32)
    mask = np.zeros((len(pick), n), np.float32)
    for i, r in enumerate(pick):
        t[i, : r.n_obs], meta[i, : r.n_obs], mask[i, : r.n_obs] = r.t, r.meta, 1.0
    theta = np.stack([trained[r.pan] for r in pick])
    p = spec.unpack(theta_from_numpy(spec, theta, dev))
    B = spec.coregional_B(p["A"], p["kappa"]).contiguous()
    K = cuda_gram.gram_lmcsm_fused(
        *(torch.as_tensor(x, device=dev) for x in (t, meta)), B, p["mu"].contiguous(),
        p["v"].contiguous(), torch.as_tensor(mask, device=dev)).double().cpu().numpy()
    err = ratio = scale = 0.0
    for i, r in enumerate(pick):
        ref = fastkernel.gram_lmcsm(theta[i], r.t.astype(np.float64), r.meta, Q, D, R)
        d = np.abs(K[i, : r.n_obs, : r.n_obs] - ref)
        err, scale = max(err, float(d.max())), max(scale, float(np.abs(ref).max()))
        ratio = max(ratio, float((d / (GRAM_ATOL + GRAM_RTOL * np.abs(ref))).max()))
    print(f"fastkernel vs K1 (n=512, {len(pick)} patients, Q={Q} D={D} R={R}, trained "
          f"thetas): max |d K| {err:.3e} (max |K| {scale:.3e}); largest error over its "
          f"bound {GRAM_ATOL:g} + {GRAM_RTOL:g} |K|: {ratio:.3f}")
    check(ratio <= 1.0, f"K1 differs from fastkernel by {ratio:.3f} of the gram tolerance")
    return dict(patients=len(pick), max_abs_err=err, max_abs_K=scale, tol_ratio=ratio)


def etl_to_run(dev):
    """From raw tables to a full-width `run` on the card: synthetic
    MIMIC-III tables, the port's ETL (held to the generator), the native
    cohort loader (bitwise the Python one), CLI `generate` and `run` on the
    ETL's cohort (features of examples/feature_all.json, LMC-SM Q=5 R=8,
    two folds, TRAIN_OPT), fastkernel against K1 on the trained thetas,
    then the mode kernel's summary and plots."""
    mimic, out = os.path.join(WORK, "mimic"), os.path.join(WORK, "data", "mimic")
    t0 = time.perf_counter()
    truth = synthetic_mimic(mimic, SEED)
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pans = extract_cohort_from_csvs(mimic, out)
    etl_s = time.perf_counter() - t0
    rows = sum(truth["rows"].values())
    print(f"ETL: tables written in {gen_s:.2f} s ({truth['rows']['chart']} CHARTEVENTS, "
          f"{truth['rows']['lab']} LABEVENTS rows); extract_cohort_from_csvs "
          f"{etl_s:.2f} s = {rows / etl_s:.0f} rows/s")
    stats_rel, stats_bitwise = check_etl(out, pans, truth)

    feature_config = os.path.join(ROOT, "examples", "feature_all.json")
    with open(feature_config) as f:
        features = [x["index"] for x in json.load(f)["feature_list"]]
    check(features == ALL_FEATURE_IDS, "feature_all.json is not the ETL's 24 signals")
    check(bindings.native_available(), "the native cohort loader did not build")
    t0 = time.perf_counter()
    native = bindings.load_cohort_native(out, pans, features)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    recs = load_cohort(out, pans, features)
    python_s = time.perf_counter() - t0
    for a, b in zip(native, recs):
        check(a.pan == b.pan and all(np.array_equal(getattr(a, k), getattr(b, k))
                                     for k in ("t", "y", "meta")),
              f"{a.pan}: the native loader's record differs from the Python loader's")
    n_obs = [r.n_obs for r in recs]
    print(f"loaders: native {native_s:.4f} s, Python {python_s:.4f} s for {len(recs)} "
          f"patients ({sum(n_obs)} observations, n {min(n_obs)}-{max(n_obs)}); bitwise equal")

    cfg_path = generate_experiment("etl", feature_config, TRAIN_OPT, Q=Q, R=R, folds=2,
                                   cohort="mimic")
    cfg = ExperimentConfig.from_json(cfg_path)
    seconds, counts, summary = run_fused("run (ETL cohort)", cfg_path, dev)
    check_train_outputs(cfg, recs)
    modes = check_mode_kernels(cfg, (-1, 0, 1))
    for mode in TEST_MODES:
        check_test_outputs(cfg, recs, mode)
    stages = run_stage_seconds(cfg)
    print(f"run (ETL cohort): stage seconds {json.dumps(stages)}; summary "
          f"{json.dumps(summary)}")
    k1 = fastkernel_vs_k1(cfg, recs, dev)

    theta, newQ = modes[-1]
    spec = LMCSMSpec(newQ, D, R)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        print_kernel_info(spec, theta)
    print(text.getvalue(), end="")
    check(len(text.getvalue().splitlines()) == newQ + 2, "print_kernel_info's lines")
    paths = vizkernel.plot_lmcsm_kernel(spec, theta, os.path.join(cfg.exp_top_dir, "plots"))
    if paths is None:
        check(not vizkernel._HAS_MPL, "plot_lmcsm_kernel returned None with matplotlib")
        print("plots: matplotlib absent, none written")
    else:
        check(len(paths) == newQ and all(map(os.path.exists, paths)), "plots missing")
        print(f"plots: {len(paths)} written ({os.path.basename(paths[0])}, ...)")
    return counts, dict(
        rows=truth["rows"], tables_s=gen_s, etl_s=etl_s, rows_per_s=rows / etl_s,
        admissions=len(pans), stats_rel=stats_rel, stats_bitwise=stats_bitwise,
        native_load_s=native_s, python_load_s=python_s, run_s=seconds, stages=stages,
        summary=summary, fastkernel_k1=k1, plots=None if paths is None else len(paths),
    )


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
    theta_rows = compare_theta_kernels(dev)
    torch.cuda.empty_cache()
    phase_done("objective batch")
    memory_budgets(dev)
    phase_done("memory budgets")

    cfg_path, cfg, recs, theta = stage_cohort()
    base = ["--cfg", cfg_path, "--device", str(dev)]
    wo_s, wo = run_path(
        "test (mean_wo_update)", ["test", *base, "--alg", "gmm", "--mode", "mean_wo_update"],
        ("gram_lmcsm", "chol_solve", "tri_inv"),
    )
    n_pred = check_test_outputs(cfg, recs, "mean_wo_update")
    print(f"test stage (mean_wo_update): {n_pred / wo_s:.1f} predictions/s")
    recheck_bucket(cfg, recs, theta, dev)
    phase_done("test mean_wo_update")

    tr_s, tr = run_path(
        "train", ["train", *base],
        ("gram_lmcsm", "chol_solve", "qmat", "gram_lmcsm_bwd", "theta_prologue",
         "theta_epilogue"),
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

    sampler_rows = sampler_potential_and_leapfrog(cfg, dev)
    torch.cuda.empty_cache()
    phase_done("sampler potential and leapfrog")
    samplers, hmc_draws = run_samplers(cfg_path, cfg, dev)
    phase_done("hmc (hmc, nuts, vi)")

    run_s, run_c, run_stages = run_full_width(dev)
    phase_done("run (full width)")
    acc_s, acc_c, acc_stages, acc_mae = run_accuracy(dev)
    phase_done("run (PT/INR accuracy)")
    own_s, own_c, own_stages, own_mae = run_own_draws(dev)
    phase_done("run (PT/INR own draws)")
    rs_s, rs_c, rs_stages = run_with_sampler(dev)
    phase_done("run --sampler hmc")
    gauss = gaussian_moments(dev)
    phase_done("Gaussian targets")
    bench_rates = sampler_rates(dev)
    phase_done("sampler rates")
    lg_c, lg_dense = large_blocked_vs_dense(dev)
    phase_done("large patient: blocked vs dense")
    lt_c, lg_train = large_train_cli(dev)
    phase_done("train (large patient)")
    lg_evals = {n: large_value_and_grad(dev, n) for n in LARGE_EVAL_N}
    phase_done("large value+gradient")
    mw_c, mesh_w1 = mesh_world1(dev, cfg, hmc_draws)
    phase_done("mesh_world1")
    run_cfg = ExperimentConfig.from_json(os.path.join(
        WORK, "exp", f"run_k7_q{Q}_r{R}_p2_e0.01", "config", "exp_setup.json"))
    ms_c, mesh_sc = mesh_shared_card(dev, run_cfg)
    phase_done("mesh_shared_card")
    ls_c, large_sc = large_sharded_shared_card(dev)
    phase_done("large_sharded_shared_card")
    ss_c, sampler_sc = sampler_shared_card(dev, cfg, hmc_draws)
    phase_done("sampler_shared_card")
    etl_c, etl_out = etl_to_run(dev)
    phase_done("etl_to_run")
    ex_c, ex_out = examples(dev, dict(seconds=run_s, launches=run_c),
                            dict(seconds=lg_train["seconds"], launches=lt_c))
    phase_done("examples")

    by_path = {
        name: {"test_wo_update": wo[name], "train": tr[name], "test_w_update": wu[name],
               "run": run_c[name], "run_ptinr": acc_c[name],
               "run_ptinr_own": own_c[name],
               **{f"hmc_{k}": v[1][name] for k, v in samplers.items()},
               "run_sampler": rs_c[name], "large_vs_dense": lg_c[name],
               "train_large": lt_c[name],
               **{f"large_{n}": c[name] for n, (c, _) in lg_evals.items()},
               **{k: c[name] for k, c in mw_c.items()},
               "mesh_run_shared_card": ms_c[name],
               "large_sharded_shared_card": ls_c[name], "hmc_shared_card": ss_c[name],
               "run_etl": etl_c[name], "launch_pod": ex_c[name]}
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
                 chol_r, "B=1024 n=512"), more_shapes=chol_more,
             large_diag_blocks=lg_dense["diag_blocks"]),
        dict(row("qmat", "qmat.cuh", "medgp_tpu/ops/pallas_chol.py:479",
                 k4[(128, 512)], "B=128 n=512"),
             tri_inv_ms=k4[(128, 512)]["tri_inv_ms"], syrk_ms=k4[(128, 512)]["syrk_ms"],
             more_shapes={f"B={b} n={n}": r for (b, n), r in k4.items()}),
        dict(row("tri_inv", "chol.cuh", "medgp_tpu/ops/pallas_chol.py:365",
                 tri_shapes["B=1024 n=512"], "B=1024 n=512"), more_shapes=tri_shapes,
             # the CLI `hmc` paths run K5's kernels inside each K4 launch only
             inside_qmat_by_path={k: v for k, v in by_path["qmat"].items()
                                  if k.startswith("hmc_")}),
        *(dict(row(name, "theta.cuh", "none: the glue XLA fuses around the Pallas kernels",
                   theta_rows[name], "B=128 n=512 Q=5 D=24 R=8"),
               device_ms=theta_rows[name]["device_ms"])
          for name in ("theta_prologue", "theta_epilogue")),
    ]
    print(f"phases (s): {json.dumps({k: round(v, 2) for k, v in phase_s.items()})}; "
          f"objective+gradient evals/s at B=128 n=512: {rates['kernels']:.1f}")
    print(f"run stages (s): full width {json.dumps(run_stages)} in {run_s:.2f}; "
          f"PT/INR {json.dumps(acc_stages)} in {acc_s:.2f}; PT/INR MAE (mean, SE, N) "
          f"{json.dumps(acc_mae)}; PT/INR own draws {json.dumps(own_stages)} in "
          f"{own_s:.2f}, MAE {json.dumps(own_mae)}")
    print(json.dumps({"samplers": {
        "potential_rows": sampler_rows,
        "hmc_phases": {k: dict(seconds=v[0], **v[2]) for k, v in samplers.items()},
        "run_sampler": dict(seconds=rs_s, stages=rs_stages),
        "gaussian": gauss, "bench_protocol": bench_rates, "shared_card": sampler_sc,
    }}))
    print(json.dumps({"large_patient": {
        "blocked_vs_dense": lg_dense, "train": lg_train,
        "value_and_grad": {n: o for n, (_, o) in lg_evals.items()},
    }}))
    print(json.dumps({"mesh": {
        "world1": mesh_w1, "run_shared_card": mesh_sc, "large_shared_card": large_sc,
    }}))
    print(json.dumps({"etl_to_run": etl_out}))
    print(json.dumps({"examples": ex_out}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0

if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[2:]))
    sys.exit(main())
