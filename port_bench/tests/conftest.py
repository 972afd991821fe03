"""Fixtures of the benchmark's own tests (python -m pytest port_bench/tests).

`tiny_root` is a checkout in a temporary directory: a copy of port_bench/
beside a link to the program's package, and a BENCHMARK.json that adds
tiny cells of both drivers (Q = 2, D = 3, R = 1, a dozen patients) to the
repository's own, so that a whole run goes through on the CPU in seconds.
Tests that need a CUDA card carry the `card` marker and skip without one.
"""

import json
import os
import shutil
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
if BENCH_DIR not in sys.path:
    sys.path[:0] = [BENCH_DIR, ROOT]


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return torch.device("cuda")


TINY = dict(Q=2, D=3, R=1, H=3 + 2 * (3 * 1 + 2 + 3), feature_index=[0, 1, 2],
            random_init_num=4)


def make_tiny_root(dest):
    shutil.copytree(BENCH_DIR, os.path.join(dest, "port_bench"),
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    os.symlink(os.path.join(ROOT, "medgp_tpu_torch"), os.path.join(dest, "medgp_tpu_torch"))
    pb = os.path.join(dest, "port_bench")
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    with open(os.path.join(pb, "configs", "lmcsm-q5-d24-r8.json")) as f:
        cfg = json.load(f)
    cfg.update(TINY, name="tiny")
    with open(os.path.join(pb, "configs", "tiny.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "traffic", "cohort1024-shard256.json")) as f:
        train = json.load(f)
    train.update(n_patients=12, n_clusters=2, n_obs=[20, 140], shard_patients=6,
                 warmup_patients_per_bucket=1)
    # limits for the CPU's plain float32 twins at this size (the cells' own
    # limits hold the card's kernels at the cells' sizes)
    train["check"].update(objective_calls_every=2, screen_patients=4, limits=dict(
        objective_value_gap=1e-4, objective_grad_gap=1e-2, screen_pick_gap=1e-9,
        step_change_gap=1e-2, estep_gap=1e-3, fit_change_gap=0.5))
    with open(os.path.join(pb, "traffic", "tiny-train.json"), "w") as f:
        json.dump(train, f)
    with open(os.path.join(pb, "traffic", "cohort256-shard64-online.json")) as f:
        online = json.load(f)
    online.update(n_patients=8, n_clusters=2, n_obs=[20, 140], shard_patients=4,
                  warmup_patients_per_bucket=1)
    online["check"].update(patients=3, limits=dict(pred_gap=1e-4, var_gap=1e-4))
    with open(os.path.join(pb, "traffic", "tiny-online.json"), "w") as f:
        json.dump(online, f)
    bench["configs"].append(dict(name="tiny", source="test", file="port_bench/configs/tiny.json",
                                 reduced=[], why="test"))
    bench["workloads"] += [
        dict(name="tiny-train", config="tiny", traffic="tiny-train", chips=1, why="test"),
        dict(name="tiny-test", config="tiny", traffic="tiny-online", chips=1, why="test"),
    ]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            test = any("test" in w for w in m["workloads"])
            m["workloads"].append("tiny-test" if test else "tiny-train")
    with open(os.path.join(dest, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f, indent=1)
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(str(tmp_path))


def run_tiny(root, workload, trace=0, seconds=2.0, seed=2**33 + 5):
    import time

    import torch

    from benchlib.harness import run_cell

    torch.set_num_threads(2)
    return run_cell(workload, seed, seconds, trace, "cpu", time.perf_counter(), root=root)
