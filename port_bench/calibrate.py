#!/usr/bin/env python3
"""Readings that the limits of a cell's checks are set from, many seeds in
one process (the benchmark's runs never run this):

    python3 port_bench/calibrate.py --workload d24-train --seeds 11 12 13 --units 2 \
        [--control] [--fault half] [--out cal.jsonl]

For each seed: the cell's set-up, `--units` units of its timed path, then
the numbers of its check for the program (the lower readings), and with
--control the same numbers with the reference computed in float32 with
TF32 on put in the program's place (the control's readings). With --fault
the program runs with that fault planted under the timed path
(benchlib/faults.py). One JSON line per seed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = os.path.join(ROOT, ".port_bench_cache", sub)
os.environ["OMP_NUM_THREADS"] = "1"  # as run.py sets it
sys.path[:0] = [HERE, ROOT]


def readings(workload, seed, units, control, fault, device="cuda", root=ROOT):
    """One seed's readings: the program's numbers (with `fault` planted),
    and with `control` the control's."""
    from benchlib.harness import run_cell

    res, checks = run_cell(workload, seed, 0, 0, device, time.perf_counter(), root=root,
                           units=units, fault=fault, control=control)
    out = dict(seed=seed, fault=fault, done=res["attempted"] - res["failed"],
               failed=res["failed"], metrics=res["metrics"],
               program={n: v for n, v, _ in checks}, program_detail=res.get("detail"))
    if control:
        out.update(control=res["control"], control_detail=res["control_detail"])
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=2)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    for s in a.seeds:
        t = time.perf_counter()
        r = readings(a.workload, s, a.units, a.control, a.fault)
        r["seconds"] = time.perf_counter() - t
        line = json.dumps(r, default=str)
        print(line, flush=True)
        if a.out:
            os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
