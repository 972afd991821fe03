"""The benchmark's run of one cell: find its files by name, set up, measure
a window, read the trace, check the outputs against the reference, print
the result line.

Everything that belongs to one cell is found by the names in
BENCHMARK.json: the configuration's `file`, the traffic mix
`port_bench/traffic/<traffic>.json`, the unit driver that the mix names
(`port_bench/drivers/<driver>.py`, a class `Driver`), and every per-layer
metric that applies to the cell (`port_bench/metrics/<name>.py`, a
function `read(r)`). A later cell, mix or metric is files and a
`workloads` entry; no file here names one.

End-to-end rates are the work the window's units completed over the time
from the window's start to the end of its last unit: the window runs whole
units back to back until `--seconds` have passed, with a device
synchronize before the clock is read. `setup_s` is from the process's
start (the first line of run.py) to the window's start.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import traceback

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "medgp_tpu")


@dataclasses.dataclass
class Context:
    seed: int
    device: object
    config: dict
    traffic: dict
    workdir: str
    cell: dict


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str, root: str = ROOT) -> dict:
    """Everything the cell `workload` is made of, found by name. A metric
    with a `workloads` key applies to the cells it lists; one without it,
    to every cell that reports the end-to-end metric it moves."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    here = os.path.join(root, "port_bench")
    traffic = load_json(os.path.join(here, "traffic", cell["traffic"] + ".json"))
    end_to_end = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    reported = {m["name"] for m in end_to_end}
    metrics = [m for m in bench["per_layer"]
               if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return dict(
        cell=cell, config=load_json(os.path.join(root, cfg["file"])), traffic=traffic,
        driver=os.path.join(here, "drivers", traffic["driver"] + ".py"),
        metrics=[(m, os.path.join(here, "metrics", m["name"] + ".py")) for m in metrics],
        end_to_end=end_to_end,
    )


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Readings:
    """What a per-layer metric reads: the trace's reductions
    (benchlib/trace.py), the work done in the traced window, the program's
    metrics records written in it, and the cell's context."""

    trace: dict
    work: int
    records: list
    ctx: Context


def _records_since(path, start):
    if not os.path.exists(path):
        return [], 0
    with open(path) as f:
        lines = f.readlines()
    return [json.loads(x) for x in lines[start:]], len(lines)


def run_cell(workload, seed, seconds, trace, device, t0, bench=None, root=ROOT,
             units=None, fault=None, control=False):
    """Run one cell; returns the result dict (the last line) and the
    checks [(name, value, limit)].

    The calibration (calibrate.py) runs the same path with `units`, a
    fixed number of units in place of `--seconds`; `fault`, a fault of
    benchlib/faults.py planted under the window; and `control`, which adds
    the control's numbers (the reference in float32 with TF32 on, in the
    program's place) to the result as `control`, and the check's details
    as `detail`. The benchmark's runs use none of them."""
    import torch

    from benchlib import faults

    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    files = cell_files(bench, workload, root)
    workdir = tempfile.mkdtemp(prefix="port_bench.")
    try:
        ctx = Context(seed=seed, device=torch.device(device), config=files["config"],
                      traffic=files["traffic"], workdir=workdir, cell=files["cell"])
        drv = load_module(files["driver"], "port_bench_driver").Driver(ctx)
        drv.setup()
        on_gpu = ctx.device.type == "cuda"
        sync = torch.cuda.synchronize if on_gpu else (lambda: None)
        log = os.path.join(workdir, "log", "metrics.jsonl")
        if on_gpu:
            torch.cuda.reset_peak_memory_stats()
        _, n_lines = _records_since(log, 0)
        done = failed = n_units = 0
        with faults.planted(fault):
            drv.open_window()
            try:
                if trace:
                    from benchlib.trace import Trace

                    with Trace() as tr:
                        with tr.window():
                            sync()
                            for i in range(int(ctx.traffic["trace_units"])):
                                d, f = drv.unit(i)
                                done, failed, n_units = done + d, failed + f, n_units + 1
                            sync()
                else:
                    sync()
                    w0 = time.perf_counter()
                    while True:
                        d, f = drv.unit(n_units)
                        done, failed, n_units = done + d, failed + f, n_units + 1
                        sync()
                        w1 = time.perf_counter()
                        if (n_units >= units) if units else (w1 - w0 >= seconds):
                            break
            finally:
                drv.close_window()
        peak = torch.cuda.max_memory_allocated() if on_gpu else 0
        records, _ = _records_since(log, n_lines)
        metrics, device_extra, breakdown = {}, {}, None
        if trace:
            t_red = time.perf_counter()
            red = tr.readings()
            tr = None  # the raw event list is large: free it before the check
            red["reduce_s"] = time.perf_counter() - t_red
            device_extra = dict(busy_s=red["busy_s"], window_s=red["window_s"])
            breakdown = dict(device_ops=red["device_ops"], idle_gaps=red["idle_gaps"])
            r = Readings(red, done, records, ctx)
            for m, path in files["metrics"]:
                value = load_module(path, "port_bench_metric").read(r)
                if value is not None:
                    metrics[m["name"]] = dict(value=value, unit=m["unit"])
            print(f"port_bench: traced {n_units} unit(s): {json.dumps(red)}", file=sys.stderr)
        else:
            values = dict(setup_s=w0 - t0)
            values[ctx.traffic["rate_metric"]] = done / (w1 - w0)
            for m in files["end_to_end"]:
                metrics[m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
            print(f"port_bench: window {w1 - w0:.3f} s, {n_units} unit(s), {done} "
                  f"{drv.work_unit} done, {failed} failed; unit seconds "
                  f"{[round(x, 3) for x in drv.unit_seconds]}",
                  file=sys.stderr)
        drv.release()
        if on_gpu:
            torch.cuda.empty_cache()
        t_check = time.perf_counter()
        checks = drv.check()
        print(f"port_bench: check {time.perf_counter() - t_check:.3f} s", file=sys.stderr)
        correct = all(v <= lim for _, v, lim in checks)
        result = dict(
            correct=bool(correct), attempted=done + failed, failed=failed, metrics=metrics,
            device=dict(
                platform="gpu" if on_gpu else ctx.device.type,
                kind=torch.cuda.get_device_name(0) if on_gpu else "cpu",
                count=int(files["cell"]["chips"]), memory_peak_bytes=int(peak),
                **device_extra),
        )
        if breakdown is not None:
            result["breakdown"] = breakdown
        if control:
            result["detail"] = drv.detail
            result["control"] = {n: v for n, v, _ in drv.check(dtype=torch.float32, tf32=True)}
            result["control_detail"] = drv.detail
        result["checks"] = {n: dict(value=_num(v), limit=lim) for n, v, lim in checks}
        return result, checks
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _num(v):
    return v if math.isfinite(v) else str(v)


def main(argv, t0):
    p = argparse.ArgumentParser(description="Run one cell of the port's benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    import torch

    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = int({w["name"]: w for w in bench["workloads"]}[a.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"port_bench: needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2
    try:
        result, checks = run_cell(a.workload, a.seed, a.seconds, a.trace, "cuda", t0, bench)
    except Exception:
        traceback.print_exc()
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"port_bench: modules loaded that the port must not load: {bad}", file=sys.stderr)
        return 3
    for name, v, lim in checks:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAILED'}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0
