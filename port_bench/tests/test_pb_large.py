"""The large-patient cell (`d24-n16384-train`) at a tiny size on the CPU: the
whole run reads `correct`, and false with each fault of
benchlib/faults_large.py planted; its files are found by name; its metric
readers and FLOP count on hand-made readings; the blocked reference
against the plain one."""

import json
import os

import pytest

from benchlib import roofline
from benchlib.harness import Context, Readings, cell_files, load_json, load_module
from conftest import BENCH_DIR, ROOT, TINY, make_tiny_root, run_tiny

CELL = "d24-n16384-train"
METRICS = ("large_mfu", "k3_diag_roofline_share.large", "large_objective_share.large",
           "large_retry_share.large")
# accepted metrics whose cells the large cell joins
SHARED = ("device_idle_share.train", "launches_per_patient.train", "host_syncs_per_patient.train")
K3 = "medgp::chol_solve_kernel(float const*, float const*, float const*, float*, float*, int)"


@pytest.fixture
def large_root(tmp_path, monkeypatch):
    """A tiny checkout with the cell `tiny-large`: Q = 2, D = 3, R = 1, two
    patients of 300 observations above a threshold of 100, and row blocks
    of at most 128 rows, so that each evaluation walks P = 3 blocks."""
    from medgp_tpu_torch.utils import hbm

    monkeypatch.setattr(hbm, "LARGE_BLOCK_MAX", 128)
    root = make_tiny_root(str(tmp_path))
    pb = os.path.join(root, "port_bench")
    cfg = load_json(os.path.join(pb, "configs", "lmcsm-q5-d24-r8-n16384.json"))
    cfg.update(TINY, name="tiny-large", n_obs=300, large_patient_threshold=100)
    with open(os.path.join(pb, "configs", "tiny-large.json"), "w") as f:
        json.dump(cfg, f)
    mix = load_json(os.path.join(pb, "traffic", "large1-n16384.json"))
    mix.update(pool_patients=2, n_clusters=2)
    # limits for the CPU's plain float32 twins at this size
    mix["check"]["limits"] = dict(large_objective_value_gap=1e-4, large_objective_grad_gap=20.0,
                                  large_screen_pick_gap=1e-9, large_step_change_gap=0.01,
                                  large_estep_gap=1e-3, large_result_gap=1e-4)
    with open(os.path.join(pb, "traffic", "tiny-large.json"), "w") as f:
        json.dump(mix, f)
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    bench["configs"].append(dict(name="tiny-large", source="test",
                                 file="port_bench/configs/tiny-large.json", reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny-large", config="tiny-large", traffic="tiny-large",
                                   chips=1, why="test"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-large")
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.mark.parametrize("fault", [None, "unchanged", "unchanged_theta", "stalled", "half",
                                   "altered", "screen"])
def test_fault_makes_the_large_run_incorrect(large_root, fault):
    from benchlib import faults_large

    with faults_large.planted(fault):
        res, checks = run_tiny(large_root, "tiny-large")
    failed = [n for n, v, lim in checks if not v <= lim]
    assert res["attempted"] >= 1 and res["failed"] == 0
    if fault is None:
        assert res["correct"] and not failed, checks
    else:
        assert not res["correct"] and failed, checks


def test_traced_large_run_reads_its_program_counters(large_root):
    res, _ = run_tiny(large_root, "tiny-large", trace=1)
    m = res["metrics"]
    assert res["correct"], res["checks"]
    # no card: no K3 kernel in the trace, so its share reads nothing
    assert set(m) == set(METRICS + SHARED) - {"k3_diag_roofline_share.large"}
    assert m["large_retry_share.large"]["value"] == 0.0
    assert 0 < m["large_objective_share.large"]["value"] < 100


def test_cell_files_find_the_driver_and_the_metrics():
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    files = cell_files(bench, CELL, ROOT)
    assert files["driver"].endswith(os.path.join("drivers", "train_large.py"))
    assert os.path.exists(files["driver"])
    assert sorted(m["name"] for m, _ in files["metrics"]) == sorted(METRICS + SHARED)
    assert all(os.path.exists(p) for _, p in files["metrics"])
    assert [m["name"] for m in files["end_to_end"]] == ["train_patients_per_s", "setup_s"]
    assert files["config"]["n_obs"] == 16384 > files["config"]["large_patient_threshold"]


def metric(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"), "m_" + name)


def readings(records, device_ops=(), window_s=100.0, busy_s=80.0, Q=5):
    ctx = Context(seed=1, device=None, config=dict(Q=Q), traffic={}, workdir="", cell={})
    trace = dict(window_s=window_s, busy_s=busy_s, device_ops=[list(x) for x in device_ops])
    return Readings(trace, 1, records, ctx)


def large(**fields):
    return dict(stage="train_large", blocks=4, block_rows=4096, **fields)


def test_large_metrics_on_hand_made_records():
    counts = {"large.evaluations": 140, "large.screen_values": 16, "large.factorizations": 160,
              "large.retry_factorizations": 4, "k3.systems": 640,
              "span_s.medgp.large.objective": 45.0, "span_s.medgp.train.large": 50.0}
    recs = [large(**counts), dict(stage="train", n_max=512, **{"k3.systems": 10**6})]
    r = readings(recs, [(K3, 20.0), ("other", 30.0)])
    n = 4 * 4096
    flops = 140 * roofline.objective_grad_flops(n, 5) + 16 * roofline.value_flops(n, 5)
    assert metric("large_mfu").read(r) == pytest.approx(100 * flops / (100.0 * roofline.PEAK_FP32))
    bound = roofline.bound_s(640 * roofline.chol_solve_flops(4096),
                             640 * roofline.chol_solve_bytes(4096))
    assert metric("k3_diag_roofline_share.large").read(r) == pytest.approx(100 * bound / 20.0)
    assert metric("large_objective_share.large").read(r) == pytest.approx(90.0)
    assert metric("large_retry_share.large").read(r) == pytest.approx(2.5)
    # a program that writes none of these fields (the records of a parent
    # without them), or a window with no large patient, reads nothing
    bare = readings([large()], [(K3, 20.0)])
    for name in METRICS:
        assert metric(name).read(bare) is None, name
    none = readings(recs[1:], [(K3, 20.0)])
    for name in METRICS:
        assert metric(name).read(none) is None, name
    assert metric("k3_diag_roofline_share.large").read(readings(recs, [("other", 1.0)])) is None


@pytest.mark.parametrize("blocks,block_rows", [(1, 16384), (2, 8192), (8, 2048), (16, 1024)])
def test_large_flops_do_not_depend_on_the_block_width(blocks, block_rows):
    record_flops = metric("large_mfu").record_flops
    rec = {"large.evaluations": 7, "large.screen_values": 3}
    want = record_flops(dict(rec, blocks=4, block_rows=4096), 5)
    assert record_flops(dict(rec, blocks=blocks, block_rows=block_rows), 5) == want
    assert record_flops(dict(blocks=4, block_rows=4096), 5) is None


@pytest.mark.parametrize("with_prior", [True, False])
def test_blocked_reference_matches_the_plain_reference(monkeypatch, with_prior):
    """reference/large.py at rows of 64 and blocks of 32 against
    reference/lmcsm.py, both in float64, at a jitter multiplier of 2."""
    import numpy as np
    import torch

    from reference import large, lmcsm, varem

    monkeypatch.setattr(large, "ROWS", 64)
    monkeypatch.setattr(large, "BLOCK", 32)
    Q, D, R, n = 2, 3, 2, 150
    rng = np.random.default_rng(3)
    t = torch.as_tensor(np.sort(rng.uniform(0, 168, n)))[None]
    y = torch.as_tensor(rng.normal(size=n))[None]
    meta = torch.as_tensor(np.concatenate([np.arange(2 * D) % D,
                                           rng.integers(0, D, n - 2 * D)]))[None]
    mask = torch.ones((1, n), dtype=torch.bool)
    theta = lmcsm.random_inits(5, Q, D, R, 1).double()
    prior = None
    if with_prior:
        prior = {k: torch.as_tensor(x)[None]
                 for k, x in varem.hier_gamma_prior(Q, D, R, 0.01, np.float64).items()}
        prior["scale"][0, D:D + 8] = torch.as_tensor(rng.uniform(0.2, 3.0, 8))
        prior["ptype"][0, D + 1] = lmcsm.PRIOR_CLAMP
    mult = torch.tensor([2.0], dtype=torch.float64)
    v, g, ok = large.objective_and_grad(theta, t, y, meta, mask, Q, D, R, prior, mult)
    wv, wg, wok = lmcsm.objective_and_grad(theta, t, y, meta, mask, Q, D, R, prior, mult)
    assert bool(ok[0]) and bool(wok[0])
    assert v.item() == pytest.approx(wv.item(), rel=1e-10)
    assert float((g - wg).abs().max()) <= 1e-10 * float(wg.abs().max())
    nv, nok = large.nlml(theta, t, y, meta, mask, Q, D, R, mult)
    wnv, _ = lmcsm.nlml(theta, t, y, meta, mask, Q, D, R, mult)
    assert bool(nok[0]) and nv.item() == pytest.approx(wnv.item(), rel=1e-10)
