"""The check catches each fault a cell can have: the whole run at a tiny
size on the CPU (the look for a card skipped), with the fault planted
under the timed path, reads `correct` false; without one, true."""

import pytest

from conftest import run_tiny


@pytest.mark.parametrize("workload,fault", [
    ("tiny-train", None), ("tiny-train", "unchanged"), ("tiny-train", "half"),
    ("tiny-train", "altered"), ("tiny-train", "screen"),
    ("tiny-test", None), ("tiny-test", "unchanged"), ("tiny-test", "half"),
    ("tiny-test", "altered"),
])
def test_fault_makes_the_run_incorrect(tiny_root, workload, fault):
    from benchlib import faults

    with faults.planted(fault):
        res, checks = run_tiny(tiny_root, workload)
    failed = [n for n, v, lim in checks if not v <= lim]
    if fault is None:
        assert res["correct"] and not failed, checks
    else:
        assert not res["correct"] and failed, checks
