"""The port's spans and counters (utils/metrics.py) and what the train and
test stages write of them into their per-bucket records.

A span times its region only while a profiler is on, and then also names
it on the profiler's clock; counters count always. Every check reads the
process-wide table as the difference of two snapshots, as the runner
does, so the tests of this file may run in any order in one process.
"""

import json
import os
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs several workers on the machine's cores: one torch
# thread each, as these small tensors gain nothing from more
torch.set_num_threads(1)

from medgp_tpu_torch.config.experiment import ExperimentConfig  # noqa: E402
from medgp_tpu_torch.data import formats  # noqa: E402
from medgp_tpu_torch.data.synthetic import cluster_thetas, sample_cohort  # noqa: E402
from medgp_tpu_torch.infer import varem  # noqa: E402
from medgp_tpu_torch.models import gp  # noqa: E402
from medgp_tpu_torch.models.params import LMCSMSpec  # noqa: E402
from medgp_tpu_torch.ops import cuda_chol, cuda_gram, nlml  # noqa: E402
from medgp_tpu_torch.parallel import runner  # noqa: E402
from medgp_tpu_torch.utils import metrics  # noqa: E402

Q, D, R = 2, 3, 1
S = 3  # restarts of the tiny train stage
TRAIN_SPANS = ("medgp.train.bucket", "medgp.train.fetch", "medgp.train.screen",
               "medgp.varem.round", "medgp.varem.estep", "medgp.scg", "medgp.objective",
               "medgp.objective.forward", "medgp.objective.backward")


def _profiled():
    return torch.autograd.profiler.profile()


def _host_names(prof):
    return {e.key for e in prof.key_averages()}


def test_nested_spans_give_self_as_total_less_children():
    before = metrics.snapshot()
    with _profiled():
        with metrics.span("medgp.t.outer"):
            time.sleep(0.002)
            for _ in range(2):
                with metrics.span("medgp.t.inner"):
                    time.sleep(0.003)
                    with metrics.span("medgp.t.leaf"):
                        time.sleep(0.001)
    d = metrics.since(before)
    assert d["calls.medgp.t.outer"] == 1 and d["calls.medgp.t.inner"] == 2
    assert d["calls.medgp.t.leaf"] == 2
    assert d["self_s.medgp.t.outer"] == pytest.approx(
        d["span_s.medgp.t.outer"] - d["span_s.medgp.t.inner"], rel=1e-9, abs=1e-12)
    assert d["self_s.medgp.t.inner"] == pytest.approx(
        d["span_s.medgp.t.inner"] - d["span_s.medgp.t.leaf"], rel=1e-9, abs=1e-12)
    assert d["self_s.medgp.t.leaf"] == pytest.approx(d["span_s.medgp.t.leaf"], rel=1e-9)
    assert d["span_s.medgp.t.outer"] >= 0.002 + 2 * 0.004
    assert d["self_s.medgp.t.outer"] >= 0.002


def test_two_snapshots_differ_by_exactly_the_work_between_them():
    g = torch.Generator().manual_seed(3)
    X = torch.randn(5, 64, 64, generator=g)
    K = X @ X.mT / 64 + torch.eye(64)
    noise, y = torch.full((5, 64), 0.1), torch.randn(5, 64, generator=g)
    metrics.count("medgp.t.counter", 2)
    before = metrics.snapshot()
    metrics.count("medgp.t.counter", 3)
    L, alpha, linvd = cuda_chol.chol_solve(K, noise, y)
    cuda_chol.tri_inv(L[:2], linvd[:2])
    cuda_chol.qmat(L, linvd, alpha, torch.ones(5))
    d = metrics.since(before)
    assert {k: v for k, v in d.items() if v} == {
        "medgp.t.counter": 3, "k3.systems": 5, "k5.systems": 2, "k4.systems": 5}
    # no launch on the CPU: the wrappers ran their plain twins
    assert all(d[f"k{i}.launches"] == 0 for i in range(1, 6))
    after = metrics.snapshot()
    assert metrics.since(after) == {k: 0 for k in after}


def test_without_a_profiler_a_span_records_nothing_and_opens_no_record_function(monkeypatch):
    opened = []
    monkeypatch.setattr(metrics, "_RecordFunctionFast", lambda name: opened.append(name))
    monkeypatch.setattr(torch.autograd.profiler, "record_function",
                        lambda name: opened.append(name))
    assert not torch.autograd._profiler_enabled()
    before = metrics.snapshot()
    with metrics.span("medgp.t.off"):
        with metrics.span("medgp.t.off.inner"):
            pass
    assert opened == []
    assert metrics.snapshot() == before


def test_counts_from_many_threads_are_not_lost():
    n_threads, n = 16, 5000
    before = metrics.snapshot()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [metrics.count("medgp.t.threads", 2)
                                                    for _ in range(n)])
                   for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert metrics.since(before)["medgp.t.threads"] == 2 * n * n_threads


def _tiny_data(n_patients=2, n_obs=(30, 60), seed=4):
    spec = LMCSMSpec(Q, D, R)
    recs = sample_cohort(seed, spec, n_patients, n_clusters=1, n_obs_range=n_obs)
    n = 128
    t = np.zeros((len(recs), n), np.float32)
    y, mask = np.zeros_like(t), np.zeros_like(t)
    meta = np.zeros((len(recs), n), np.int32)
    for i, r in enumerate(recs):
        t[i, :r.n_obs], y[i, :r.n_obs], meta[i, :r.n_obs], mask[i, :r.n_obs] = \
            r.t, r.y, r.meta, 1.0
    data = gp.PatientData(*map(torch.as_tensor, (t, y, meta, mask)))
    theta = torch.as_tensor(cluster_thetas(seed, spec, 1)[0], dtype=torch.float32)
    return spec, data, theta


def test_spans_appear_as_host_events_under_the_cpu_profiler():
    spec, data, theta = _tiny_data()
    f = gp.objective_and_grad(spec, data)
    before = metrics.snapshot()
    with _profiled() as prof:
        f(theta.expand(2, -1))
    names = _host_names(prof)
    for name in ("medgp.objective", "medgp.objective.forward", "medgp.objective.backward"):
        assert name in names
    d = metrics.since(before)
    assert d["calls.medgp.objective"] == 1
    assert d["k1.systems"] == d["k2.systems"] == d["k3.systems"] == d["k4.systems"] == 2


def test_the_jitter_loop_counts_the_systems_it_factors_again():
    g = torch.Generator().manual_seed(5)
    X = torch.randn(3, 32, 32, generator=g)
    K = X @ X.mT / 32 + torch.eye(32)
    # the second system's least eigenvalue is -0.05: indefinite with the
    # noise added once (0.04), positive definite with it added twice
    K[1] -= (torch.linalg.eigvalsh(K[1])[0] + 0.05) * torch.eye(32)
    noise = torch.full((3, 32), 0.04)
    y = torch.randn(3, 32, generator=g)
    before = metrics.snapshot()
    with _profiled() as prof:
        _, _, _, ok, mult = nlml.jittered_chol_solve(K, y, noise, max_retries=3)
    d = metrics.since(before)
    assert ok.all() and mult.tolist() == [1, 2, 1]
    assert d["k3.retry_systems"] == 1 and d["k3.systems"] == 4
    assert d["calls.medgp.k3.retry"] == 1 and "medgp.k3.retry" in _host_names(prof)


def _experiment(root):
    (root / "test").mkdir()
    return ExperimentConfig(
        data_dir=str(root / "data"), exp_top_dir=str(root), exp_log_dir=str(root / "log"),
        exp_kernel_dir=str(root / "kernel"), exp_test_dir=str(root / "test"),
        Q=Q, D=D, R=R, feature_index="0 1 2 ", random_init_num=S, top_iteration_num=2,
        iteration_num_per_update=6, eta=0.01, beta_lam=0.01,
    )


def _records(cfg, stage):
    with open(os.path.join(cfg.exp_log_dir, "metrics.jsonl")) as f:
        return [r for r in map(json.loads, f) if r["stage"] == stage]


def test_train_records_carry_spans_and_count_every_k3_system(tmp_path, monkeypatch):
    """Under the profiler every `train` record carries the bucket's spans,
    and its K3 systems are exactly the screen's (patient, restart) pairs,
    the systems of every objective call and the jitter loop's retries;
    `evaluations`, SCG's budget (every evaluation and one tick per line
    search, as the reference counts), is at least the objective's
    systems."""
    cfg = _experiment(tmp_path)
    cfg.top_iteration_num = 1  # one varEM round of SCG's warm-up budget
    recs = sample_cohort(6, LMCSMSpec(Q, D, R), 3, n_clusters=1, n_obs_range=(20, 60))
    objective_systems, objective_calls = [], []
    orig = varem.objective_and_grad

    def counted(*a, **k):
        f = orig(*a, **k)

        def g(theta, idx=None):
            objective_systems[-1] += theta.shape[0]
            objective_calls[-1] += 1
            return f(theta, idx)
        return g

    monkeypatch.setattr(varem, "objective_and_grad", counted)
    orig_bucket = runner.train_one_patient

    def bucket(*a, **k):
        objective_systems.append(0)
        objective_calls.append(0)
        return orig_bucket(*a, **k)

    monkeypatch.setattr(runner, "train_one_patient", bucket)
    with _profiled() as prof:
        runner.train_cohort(cfg, recs, write=False, max_batch=2, device="cpu")
    rows = _records(cfg, "train")
    assert len(rows) == len(objective_systems) == 2  # buckets of 2 and 1 patients
    for r, obj, calls in zip(rows, objective_systems, objective_calls):
        for name in TRAIN_SPANS:
            assert r["calls." + name] >= 1, name
            assert r["span_s." + name] >= r["self_s." + name] >= 0, name
        assert r["k3.systems"] == S * r["batch"] + obj + r["k3.retry_systems"]
        assert r["k1.systems"] == S * r["batch"] + obj
        assert r["k2.systems"] == r["k4.systems"] == r["objective.fused_systems"] == obj
        assert r["calls.medgp.objective"] == calls
        assert r["evaluations"] >= obj > 0
        assert r["k5.systems"] == 0
        assert all(r[f"k{i}.launches"] == 0 for i in range(1, 6))
        assert r["span_s.medgp.train.bucket"] >= r["span_s.medgp.varem.round"] \
            >= r["span_s.medgp.scg"] >= r["span_s.medgp.objective"]
    assert set(TRAIN_SPANS) <= _host_names(prof)


def test_test_records_carry_the_online_spans_and_kernel_systems(tmp_path):
    cfg = _experiment(tmp_path)
    spec = LMCSMSpec(Q, D, R)
    recs = sample_cohort(8, spec, 3, n_clusters=1, n_obs_range=(20, 60))
    formats.write_mode_kernel(cfg.exp_kernel_dir, -1, "gmm",
                              np.asarray(cluster_thetas(8, spec, 1)[0], np.float64), Q)
    with _profiled() as prof:
        runner.test_cohort(cfg, recs, modes=("mean_w_update",), device="cpu")
    rows = _records(cfg, "test")
    assert len(rows) == 1 and rows[0]["mode"] == "mean_w_update"
    r = rows[0]
    for name in ("medgp.test.bucket", "medgp.online.update", "medgp.online.predict"):
        assert r["calls." + name] >= 1, name
        assert r["span_s." + name] > 0, name
    assert r["span_s.medgp.test.bucket"] >= \
        r["span_s.medgp.online.update"] + r["span_s.medgp.online.predict"]
    assert r["k1.systems"] > 0 and r["k3.systems"] > 0 and r["k5.systems"] > 0
    # every update is one objective call, through the fused objective: K2,
    # K4 and its backward count its systems
    assert r["k2.systems"] == r["k4.systems"] == r["objective.fused_systems"] > 0
    assert {"medgp.test.bucket", "medgp.online.update", "medgp.online.predict",
            "medgp.objective"} <= _host_names(prof)


def test_records_written_without_a_profiler_carry_counters_and_no_spans(tmp_path):
    cfg = _experiment(tmp_path)
    spec = LMCSMSpec(Q, D, R)
    recs = sample_cohort(8, spec, 2, n_clusters=1, n_obs_range=(20, 40))
    formats.write_mode_kernel(cfg.exp_kernel_dir, -1, "gmm",
                              np.asarray(cluster_thetas(8, spec, 1)[0], np.float64), Q)
    runner.test_cohort(cfg, recs, modes=("mean_w_update",), device="cpu")
    (r,) = _records(cfg, "test")
    assert r["k3.systems"] > 0 and r["k3.launches"] == 0
    assert r["objective.fused_systems"] == r["k4.systems"] > 0
    assert r.get("calls.medgp.test.bucket", 0) == 0
    assert r.get("span_s.medgp.online.update", 0) == 0


def test_wrappers_count_their_batches_on_the_cpu():
    spec, data, theta = _tiny_data(3)
    p = spec.unpack(theta)
    B = spec.coregional_B(p["A"], p["kappa"]).expand(3, -1, -1, -1).contiguous()
    mu, v = p["mu"].expand(3, -1).contiguous(), p["v"].expand(3, -1).contiguous()
    before = metrics.snapshot()
    K = cuda_gram.gram_lmcsm_fused(data.t, data.meta, B, mu, v, mask=data.mask)
    cuda_gram.gram_lmcsm_bwd(torch.ones_like(K), data.t, data.meta, B, mu, v, data.mask)
    d = metrics.since(before)
    assert d["k1.systems"] == 3 and d["k2.systems"] == 3
    assert d["k1.launches"] == d["k2.launches"] == 0
