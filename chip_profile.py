#!/usr/bin/env python3
"""Where the time goes in the port's train and mean_w_update stages, on one
CUDA card.

    python3 chip_profile.py

Stages chip_smoke.py's 64-patient cohort (LMC-SM Q=5, D=24, R=8) and its
cut train budget (chip_smoke.TRAIN_OPT), runs each stage once to warm up,
then once more under `torch.profiler`, and prints for each: the wall time,
the device's busy time and idle share, device time by kernel (the 12
largest and every kernel of the port), and the host calls that wait for
the device or launch work. Working files go to
.chip_smoke/ beside it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from medgp_tpu_torch.data.cohort import load_cohort
from medgp_tpu_torch.ops import cuda_build
from medgp_tpu_torch.parallel.runner import test_cohort, train_cohort

HOST_CALLS = ("cudaStreamSynchronize", "cudaMemcpyAsync", "cudaLaunchKernel")


def profiled(name, fn):
    fn()  # warm-up: allocator, library handles, first launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name = {}  # device-side events (kernels, copies, fills): name -> [us, count]
    host = dict.fromkeys(HOST_CALLS, 0)
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            acc = by_name.setdefault(e.name, [0.0, 0])
            acc[0] += e.time_range.elapsed_us()
            acc[1] += 1
        elif e.name in host:
            host[e.name] += 1
    busy = sum(us for us, _ in by_name.values()) / 1e6
    print(f"{name}: wall {wall:.3f} s, device busy {busy:.3f} s, "
          f"idle {100 * (1 - busy / wall):.1f}% of the wall")
    # the 12 largest, then the port's own kernels that are not among them
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    shown = ranked[:12] + [kv for kv in ranked[12:] if kv[0].startswith("medgp::")]
    for key, (us, count) in shown:
        print(f"  {us / 1e3:10.1f} ms {100 * us / 1e6 / busy:5.1f}% x{count:<6d} {key[:90]}")
    print(f"  host calls: {host}")


def main():
    if not torch.cuda.is_available():
        print("chip_profile: torch.cuda.is_available() is false; this "
              "profile runs only on a CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    shutil.rmtree(chip_smoke.WORK, ignore_errors=True)
    os.makedirs(chip_smoke.WORK)
    cuda_build.build_library()
    dev = torch.device("cuda", 0)
    _, cfg, _, _ = chip_smoke.stage_cohort()
    records = load_cohort(cfg.data_dir, cfg.pans(), cfg.feature_list)
    profiled("train", lambda: train_cohort(cfg, records, write=False, device=dev))
    folds = np.zeros(len(records), int)
    profiled("test mean_w_update", lambda: test_cohort(
        cfg, records, folds=folds, modes=("mean_w_update",), device=dev))
    profiled("test mean_wo_update", lambda: test_cohort(
        cfg, records, folds=folds, modes=("mean_wo_update",), device=dev))
    return 0


if __name__ == "__main__":
    sys.exit(main())
