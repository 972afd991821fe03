#!/usr/bin/env python3
"""bench.py's sampler protocol (chip_smoke.py:sampler_rates) of two
checkouts on one card, alternated: other, this, this, other.

    python3 tools/sampler_rates_ab.py --other _archive/parent

`--other` is the root of another checkout of the repo (for example the
parent commit, unpacked with `git archive` into the gitignored
`_archive/`). Each run is a process of its own, started from that root:
it builds the kernels there (medgp_tpu_torch/build/ of that root), runs
`sampler_rates` once (a warm-up run and a timed run of HMC, NUTS and
ADVI) and prints its JSON. This prints the card's name and power limit,
then one JSON line: every run's draws/s and steps/s in order, with HMC's
and NUTS's accept rates, jitter retries per transition (K3 launches
beyond one per objective batch, from the launch counts sampler_rates
reads after each timed run) and milliseconds per objective batch, and
each checkout's range. It needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD = """
import json, os, sys
sys.path.insert(0, os.getcwd())
import torch
import chip_smoke
from medgp_tpu_torch.ops import cuda_build
cuda_build.build_library()
reads, own = [], chip_smoke.read_launches


def reading():
    counts = own()
    reads.append(counts)
    return counts


# sampler_rates reads the counts once after each timed run: hmc, nuts, vi
chip_smoke.read_launches = reading
rates = chip_smoke.sampler_rates(torch.device("cuda", 0))
for name, counts in zip(("hmc", "nuts", "vi"), reads):
    rates[name]["launches"] = counts
print("RATES " + json.dumps(rates), flush=True)
"""


def one(root: str) -> dict:
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=root, capture_output=True,
                         text=True, timeout=900)
    if out.returncode:
        raise RuntimeError(f"{root}: exited {out.returncode}\n{out.stderr[-3000:]}")
    line = [x for x in out.stdout.splitlines() if x.startswith("RATES ")][-1]
    return json.loads(line[len("RATES "):])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--other", required=True, help="root of the other checkout")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("sampler_rates_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    other = os.path.abspath(args.other)
    runs = []
    for name, root in (("other", other), ("this", ROOT), ("this", ROOT), ("other", other)):
        r = one(root)
        run = dict(checkout=name, hmc_draws_per_s=r["hmc"]["draws_per_s"],
                   nuts_draws_per_s=r["nuts"]["draws_per_s"],
                   vi_steps_per_s=r["vi"]["steps_per_s"],
                   hmc_min_ess_per_s=r["hmc"]["min_ess_per_s"],
                   nuts_host_reads_per_transition=r["nuts"]["host_reads_per_transition"])
        for s in ("hmc", "nuts"):
            x = r[s]
            transitions = x["objective_batches"] / x["batches_per_transition"]
            run.update({
                f"{s}_accept_rate": x["accept_rate"],
                # K3 launches beyond one per objective batch: jitter retries
                f"{s}_k3_retries_per_transition":
                    (x["launches"]["chol_solve"] - x["objective_batches"]) / transitions,
                f"{s}_ms_per_objective_batch": 1e3 * x["seconds"] / x["objective_batches"],
            })
        runs.append(run)
        print(json.dumps(runs[-1]), flush=True)
    keys = ("hmc_draws_per_s", "nuts_draws_per_s", "vi_steps_per_s")
    ranges = {c: {k: [min(r[k] for r in runs if r["checkout"] == c),
                      max(r[k] for r in runs if r["checkout"] == c)] for k in keys}
              for c in ("other", "this")}
    print(json.dumps(dict(runs=runs, ranges=ranges)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
