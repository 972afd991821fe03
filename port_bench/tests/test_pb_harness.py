"""The harness on the CPU at a tiny size: discovery by name, the result
line, and the JAX-free check."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from conftest import BENCH_DIR, ROOT, run_tiny


def _tree_hashes(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "port_bench")):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = hashlib.sha256(fh.read()).hexdigest()
    return out


def test_new_config_mix_and_metric_are_files_plus_an_entry(tiny_root):
    """A configuration, a traffic mix and a per-layer metric added as files,
    with a `workloads` entry and the metric's entry, are picked up; no file
    that was there changes."""
    from benchlib.harness import cell_files, load_json

    before = _tree_hashes(tiny_root)
    pb = os.path.join(tiny_root, "port_bench")
    cfg = load_json(os.path.join(pb, "configs", "tiny.json"))
    cfg.update(name="tiny2", R=2, H=3 + 2 * (3 * 2 + 2 + 3))
    with open(os.path.join(pb, "configs", "tiny2.json"), "w") as f:
        json.dump(cfg, f)
    mix = load_json(os.path.join(pb, "traffic", "tiny-train.json"))
    mix.update(n_patients=10, shard_patients=5)
    with open(os.path.join(pb, "traffic", "tiny-train-10.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "metrics", "work_seen.train.py"), "w") as f:
        f.write('"""Work done in the traced window."""\n\n\ndef read(r):\n    return float(r.work)\n')
    bench = load_json(os.path.join(tiny_root, "BENCHMARK.json"))
    bench["configs"].append(dict(name="tiny2", source="test", file="port_bench/configs/tiny2.json",
                                 reduced=[], why="test"))
    bench["workloads"].append(dict(name="tiny2-train", config="tiny2", traffic="tiny-train-10",
                                   chips=1, why="test"))
    bench["end_to_end"][0]["workloads"].append("tiny2-train")
    bench["per_layer"].append(dict(name="work_seen.train", unit="patients", better="higher",
                                   source="program_counter", layer="runner",
                                   moves="train_patients_per_s", workloads=["tiny2-train"]))
    for m in bench["per_layer"]:
        if "tiny-train" in m.get("workloads", []):
            m["workloads"].append("tiny2-train")
    with open(os.path.join(tiny_root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    after = _tree_hashes(tiny_root)
    assert {k: after[k] for k in before} == before

    files = cell_files(bench, "tiny2-train", tiny_root)
    assert files["config"]["R"] == 2 and files["traffic"]["n_patients"] == 10
    assert files["driver"].endswith(os.path.join("drivers", "train_cohort.py"))
    assert "work_seen.train" in [m["name"] for m, _ in files["metrics"]]
    res, _ = run_tiny(tiny_root, "tiny2-train", trace=1)
    assert res["metrics"]["work_seen.train"]["value"] == res["attempted"] - res["failed"]
    assert res["correct"], res["checks"]


def test_metric_without_workloads_applies_to_every_cell_that_reports_what_it_moves(tiny_root):
    from benchlib.harness import cell_files, load_json

    bench = load_json(os.path.join(tiny_root, "BENCHMARK.json"))
    bench["per_layer"].append(dict(name="work_seen.any_train", unit="patients", better="higher",
                                   source="program_counter", layer="runner",
                                   moves="train_patients_per_s"))
    for w in bench["workloads"]:
        names = [m["name"] for m, _ in cell_files(bench, w["name"], tiny_root)["metrics"]]
        reports = any(w["name"] in m.get("workloads", [w["name"]]) for m in bench["end_to_end"]
                      if m["name"] == "train_patients_per_s")
        assert ("work_seen.any_train" in names) == reports, w["name"]


@pytest.mark.parametrize("workload,rate", [("tiny-train", "train_patients_per_s"),
                                           ("tiny-test", "predictions_per_s")])
def test_result_line(tiny_root, workload, rate):
    res, checks = run_tiny(tiny_root, workload)
    line = json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checks"
    assert line["correct"] is True and line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {rate, "setup_s"}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert [n for n, _, _ in checks] == list(line["checks"])
    assert all(c["value"] <= c["limit"] for c in line["checks"].values())


def test_traced_line(tiny_root):
    res, _ = run_tiny(tiny_root, "tiny-train", trace=1)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in res["metrics"] and "bucket_patients.train" in res["metrics"]


def test_forbidden_modules_compare_top_level_names_whole(monkeypatch):
    from benchlib import harness

    for name in ("medgp_tpu_torch", "medgp_tpu_torch.ops", "jaxtyping_like", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [] or "jax" in sys.modules
    for name, top in (("medgp_tpu.models", "medgp_tpu"), ("jaxlib.xla", "jaxlib")):
        monkeypatch.setitem(sys.modules, name, sys)
        assert top in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole tiny run, the harness, drivers, metrics and reference
    included, in a fresh process: no loaded module's top-level name is
    jax, jaxlib, flax or medgp_tpu; the reference alone loads nothing of
    the program either."""
    code = f"""
import sys, tempfile
sys.path[:0] = [{BENCH_DIR!r}, {ROOT!r}, {os.path.join(BENCH_DIR, 'tests')!r}]
import conftest
root = conftest.make_tiny_root(tempfile.mkdtemp())
for w in ("tiny-train", "tiny-test"):
    res, _ = conftest.run_tiny(root, w, trace=1)
    assert res["correct"], res
import glob, importlib.util
for p in glob.glob({os.path.join(BENCH_DIR, 'metrics', '*.py')!r}):
    spec = importlib.util.spec_from_file_location("m", p)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
from benchlib.harness import forbidden_modules
print(sorted({{n.split('.')[0] for n in sys.modules}}))
assert forbidden_modules() == [], forbidden_modules()
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = subprocess.run(
        [sys.executable, "-c",
         f"import sys; sys.path[:0] = [{BENCH_DIR!r}]; import reference.lmcsm, reference.varem; "
         "tops = {n.split('.')[0] for n in sys.modules}; "
         "assert not tops & {'jax', 'jaxlib', 'flax', 'medgp_tpu', 'medgp_tpu_torch'}, tops"],
        capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH_DIR, "run.py"), "--workload", "d24-train",
         "--seed", "5", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout.strip() == ""
