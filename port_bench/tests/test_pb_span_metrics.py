"""The metrics that read the program's spans and counters, on hand-made
readings: each formula, and None wherever what it reads is missing, as
from a program that writes no such fields."""

import os

import pytest

from benchlib import roofline
from benchlib.harness import Context, Readings, load_module
from conftest import BENCH_DIR

K3 = "medgp::chol_solve_kernel(float const*, float const*, float const*, float*, float*, int)"


def metric(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"), "m_" + name)


def readings(records, device_ops=(), window_s=2.0, Q=5):
    ctx = Context(seed=1, device=None, config=dict(Q=Q), traffic={}, workdir="", cell={})
    trace = dict(window_s=window_s, busy_s=0.5, device_ops=[list(x) for x in device_ops])
    return Readings(trace, 10, records, ctx)


def train(n_max, **fields):
    return dict(stage="train", n_max=n_max, batch=4, **fields)


def test_k3_window_roofline_share_sums_each_records_bound():
    m = metric("k3_window_roofline_share.train")
    recs = [train(128, **{"k3.systems": 100}), train(512, **{"k3.systems": 30}),
            dict(stage="test", n_max=512, **{"k3.systems": 10**6})]
    want = (roofline.bound_s(100 * roofline.chol_solve_flops(128),
                             100 * roofline.chol_solve_bytes(128))
            + roofline.bound_s(30 * roofline.chol_solve_flops(512),
                               30 * roofline.chol_solve_bytes(512)))
    ops = [(K3, 0.25), ("medgp::qmat_syrk_kernel(...)", 9.0), (K3 + " other", 0.75)]
    assert m.read(readings(recs, ops)) == pytest.approx(100 * want / 1.0)
    assert m.read(readings(recs, [("medgp::qmat_syrk_kernel(...)", 9.0)])) is None
    assert m.read(readings([train(128)], ops)) is None
    assert m.read(readings([], ops)) is None


def test_k3_window_roofline_share_of_the_test_window_reads_test_records():
    m = metric("k3_window_roofline_share.test")
    recs = [dict(stage="test", n_max=256, **{"k3.systems": 64}),
            train(512, **{"k3.systems": 10**6})]
    want = roofline.bound_s(64 * roofline.chol_solve_flops(256),
                            64 * roofline.chol_solve_bytes(256))
    assert m.read(readings(recs, [(K3, 0.5)])) == pytest.approx(100 * want / 0.5)
    assert m.read(readings(recs[1:], [(K3, 0.5)])) is None


def test_test_mfu_counts_every_kernels_systems_at_their_length():
    m = metric("test_mfu")
    counts = {"k1.systems": 7, "k2.systems": 3, "k3.systems": 11, "k4.systems": 3,
              "k5.systems": 8}
    recs = [dict(stage="test", n_max=128, **counts), dict(stage="test", n_max=256, **counts),
            train(512, **counts)]
    Q = 5
    per = lambda n: (7 * roofline.gram_flops(n, Q) + 3 * roofline.gram_bwd_flops(n, Q)  # noqa: E731
                     + 11 * roofline.chol_solve_flops(n) + 3 * roofline.qmat_flops(n)
                     + 8 * roofline.tri_inv_flops(n))
    want = 100 * (per(128) + per(256)) / (4.0 * roofline.PEAK_FP32)
    assert m.read(readings(recs, window_s=4.0, Q=Q)) == pytest.approx(want)
    lacking = dict(counts)
    del lacking["k5.systems"]
    assert m.read(readings([dict(stage="test", n_max=128, **lacking)])) is None
    assert m.read(readings(recs, window_s=0.0)) is None
    assert m.read(readings(recs[2:])) is None


def test_scg_self_share_is_scg_self_time_over_the_buckets():
    m = metric("scg_self_share.train")
    recs = [train(128, **{"self_s.medgp.scg": 1.0, "span_s.medgp.train.bucket": 4.0}),
            train(256, **{"self_s.medgp.scg": 2.0, "span_s.medgp.train.bucket": 8.0})]
    assert m.read(readings(recs)) == pytest.approx(25.0)
    assert m.read(readings([train(128, **{"span_s.medgp.train.bucket": 4.0})])) is None
    assert m.read(readings([train(128, **{"self_s.medgp.scg": 0.0,
                                          "span_s.medgp.train.bucket": 0.0})])) is None


def test_online_update_share_is_the_updates_over_the_buckets():
    m = metric("online_update_share.test")
    recs = [dict(stage="test", **{"span_s.medgp.online.update": 3.0,
                                  "span_s.medgp.test.bucket": 5.0}),
            dict(stage="test", **{"span_s.medgp.online.update": 1.0,
                                  "span_s.medgp.test.bucket": 3.0})]
    assert m.read(readings(recs)) == pytest.approx(50.0)
    assert m.read(readings([dict(stage="test", **{"span_s.medgp.test.bucket": 5.0})])) is None
    assert m.read(readings([])) is None


def test_k3_retry_share_is_the_retried_systems_over_all():
    m = metric("k3_retry_share.train")
    recs = [train(128, **{"k3.systems": 300, "k3.retry_systems": 6}),
            train(256, **{"k3.systems": 100, "k3.retry_systems": 0})]
    assert m.read(readings(recs)) == pytest.approx(1.5)
    assert m.read(readings([train(128, **{"k3.systems": 300})])) is None
    assert m.read(readings([train(128, **{"k3.systems": 0, "k3.retry_systems": 0})])) is None
