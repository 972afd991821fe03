"""On the card (`card` marker; skips without one): for every cell of
BENCHMARK.json, one unit of its timed path at the cell's own size passes
its check, and the control, the reference computed in float32 with TF32 on
put in the program's place, fails at least one of its numbers.

    python -m pytest -q -p no:cacheprovider -n 0 port_bench/tests/test_pb_card.py
"""

import json
import os

import pytest

from conftest import ROOT

with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    CELLS = [w["name"] for w in json.load(_f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_program_passes_and_control_fails(card, workload):
    import calibrate
    from benchlib.harness import cell_files, load_json

    limits = cell_files(load_json(os.path.join(ROOT, "BENCHMARK.json")), workload)["traffic"]["check"]["limits"]
    r = calibrate.readings(workload, 5_000_000_007, 1, True, None, device="cuda")
    assert all(v <= limits[n] for n, v in r["program"].items()), r
    assert any(not v <= limits[n] for n, v in r["control"].items()), r
