#!/usr/bin/env python3
"""Readings that the limits of the large-patient cell's checks are set from,
as calibrate.py takes them, with the faults of benchlib/faults_large.py
(which patch the row-blocked path that benchlib/faults.py does not reach):

    python3 port_bench/calibrate_large.py --workload d24-n16384-train --seeds 11 12 \
        --units 1 [--control] [--fault half] [--out cal.jsonl]

One JSON line per seed (calibrate.py's `readings`).
"""

import argparse
import json
import os
import sys
import time

import calibrate  # sets the caches and the path as run.py does
from benchlib import faults_large


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=1)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", default=None, choices=faults_large.FAULTS)
    p.add_argument("--out", default=None)
    a = p.parse_args()
    for s in a.seeds:
        t = time.perf_counter()
        with faults_large.planted(a.fault):
            r = calibrate.readings(a.workload, s, a.units, a.control, None)
        r.update(fault=a.fault, seconds=time.perf_counter() - t)
        line = json.dumps(r, default=str)
        print(line, flush=True)
        if a.out:
            os.makedirs(os.path.dirname(a.out) or ".", exist_ok=True)
            with open(a.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
