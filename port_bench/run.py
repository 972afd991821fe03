#!/usr/bin/env python3
"""Run one cell of the benchmark of medgp_tpu_torch on this machine's GPU.

    python3 port_bench/run.py --workload d24-train --seed 12345 --seconds 30 --trace 0

Prints one JSON object as the last line of standard output: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), `device` and last `checks` (each number
compared with the reference, beside its limit). Exits 2 without enough
CUDA devices, 3 if JAX or the JAX package was loaded, 1 on an error.
"""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".port_bench_cache", sub)
# one host thread for PyTorch's CPU pool: the measured path is one Python
# loop driving the card, and on an 8-core H100 host the PT/INR train rate
# read about 10% lower with the pool at its default of 8 threads
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [HERE, ROOT]

from benchlib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
