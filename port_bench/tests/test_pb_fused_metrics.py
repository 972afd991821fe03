"""The metrics that read the fused objective's counter
(`objective.fused_systems`, medgp_tpu_torch/ops/objective.py) on hand-made
readings: each formula, and None wherever what it reads is missing, as
from a program that writes no such field."""

import os

import pytest

from benchlib.harness import Context, Readings, load_module
from conftest import BENCH_DIR


def metric(name):
    return load_module(os.path.join(BENCH_DIR, "metrics", name + ".py"), "m_" + name)


def readings(records):
    ctx = Context(seed=1, device=None, config=dict(Q=5), traffic={}, workdir="", cell={})
    trace = dict(window_s=2.0, busy_s=0.5, device_ops=[])
    return Readings(trace, 10, records, ctx)


@pytest.mark.parametrize("stage", ["train", "test"])
def test_objective_fused_share_is_fused_systems_over_k4_systems(stage):
    m = metric("objective_fused_share." + stage)
    other = "test" if stage == "train" else "train"
    recs = [dict(stage=stage, **{"objective.fused_systems": 90, "k4.systems": 100}),
            dict(stage=stage, **{"objective.fused_systems": 30, "k4.systems": 60}),
            dict(stage=other, **{"objective.fused_systems": 0, "k4.systems": 10**6})]
    assert m.read(readings(recs)) == pytest.approx(75.0)
    assert m.read(readings([dict(stage=stage, **{"k4.systems": 100})])) is None
    assert m.read(readings([dict(stage=stage, **{"objective.fused_systems": 0,
                                                 "k4.systems": 0})])) is None
    assert m.read(readings(recs[2:])) is None
