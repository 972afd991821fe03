"""The port's native cohort loader (runtime/io.cpp through ctypes) against
the JAX package's native loader and the port's Python loader, bitwise, and
the CLI's `_load_records`, which picks between them."""

import logging
import os
import types

import numpy as np
import pytest

from medgp_tpu.runtime import bindings as jax_bindings
from medgp_tpu_torch.cli import main as cli_main
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import load_cohort
from medgp_tpu_torch.data.synthetic import sample_cohort, write_reference_format_cohort
from medgp_tpu_torch.models.params import LMCSMSpec
from medgp_tpu_torch.ops.cuda_build import BUILD_DIR
from medgp_tpu_torch.runtime import bindings

FEATURES = [0, 4, 9, 18]


@pytest.fixture(scope="module")
def cohort_dir(tmp_path_factory):
    """Six patients of 15-120 observations over four features, with
    cohort stats that are not (0, 1), so that the normalization shows."""
    d = str(tmp_path_factory.mktemp("native_cohort"))
    recs = sample_cohort(7, LMCSMSpec(2, len(FEATURES), 1), n_patients=6,
                         n_obs_range=(15, 120))
    write_reference_format_cohort(d, recs, FEATURES)
    rng = np.random.default_rng(718)
    for fid in FEATURES:
        formats.write_feature_stat(os.path.join(d, f"feature{fid}_stat.bin"),
                                   float(rng.normal(50, 20)), float(rng.uniform(0.3, 9)))
    return d, [r.pan for r in recs]


def assert_records_equal(got, want):
    assert [r.pan for r in got] == [r.pan for r in want]
    for a, b in zip(got, want):
        for k in ("t", "y", "meta"):
            x, y = getattr(a, k), getattr(b, k)
            assert x.dtype == y.dtype and np.array_equal(x, y), (a.pan, k)


def test_native_builds_into_build_dir():
    assert bindings.native_available(), "g++ build of runtime/io.cpp failed"
    path = bindings.library_path()
    assert os.path.dirname(path) == BUILD_DIR and os.path.exists(path)
    assert os.path.basename(path).startswith("libmedgp_io-")
    runtime = os.path.dirname(bindings.SOURCE)
    assert sorted(f for f in os.listdir(runtime) if f != "__pycache__") == [
        "__init__.py", "bindings.py", "io.cpp"]


@pytest.mark.parametrize("features", [FEATURES, [18, 0]], ids=["all", "reordered"])
def test_counts_match(cohort_dir, features):
    d, pans = cohort_dir
    counts = bindings.count_cohort_native(d, pans, features)
    assert counts.dtype == np.int64
    np.testing.assert_array_equal(counts, jax_bindings.count_cohort_native(d, pans, features))
    np.testing.assert_array_equal(counts, [r.n_obs for r in load_cohort(d, pans, features)])


@pytest.mark.parametrize("n_threads", [1, 3])
@pytest.mark.parametrize("features", [FEATURES, [18, 0]], ids=["all", "reordered"])
def test_load_bitwise(cohort_dir, features, n_threads):
    """Bitwise the JAX package's native loader and the port's Python one."""
    d, pans = cohort_dir
    got = bindings.load_cohort_native(d, pans, features, n_threads=n_threads)
    assert_records_equal(got, load_cohort(d, pans, features))
    assert_records_equal(got, jax_bindings.load_cohort_native(d, pans, features))


def test_missing_patient(cohort_dir):
    d, pans = cohort_dir
    mixed = [pans[0], "nonexistent", pans[1]]
    np.testing.assert_array_equal(
        bindings.count_cohort_native(d, ["nonexistent"], FEATURES), [0])
    got = bindings.load_cohort_native(d, mixed, FEATURES)
    assert got[1].pan == "nonexistent" and got[1].n_obs == 0
    assert_records_equal(got, load_cohort(d, mixed, FEATURES))


def test_build_failure_is_unavailable(monkeypatch):
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    bindings._load.cache_clear()
    try:
        assert not bindings.native_available()
        with pytest.raises(RuntimeError, match="unavailable"):
            bindings.count_cohort_native(".", ["p"], FEATURES)
    finally:
        monkeypatch.undo()
        bindings._load.cache_clear()
    assert bindings.native_available()


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_cli_load_records(cohort_dir, caplog, monkeypatch, native):
    """`_load_records` logs the loader it ran and gives the Python loader's
    records; the cohort's pans by default, or the ones asked for."""
    d, pans = cohort_dir
    if not native:
        monkeypatch.setattr(bindings, "native_available", lambda: False)
    cfg = types.SimpleNamespace(data_dir=d, feature_list=FEATURES, pans=lambda: pans)
    with caplog.at_level(logging.INFO, logger="medgp_tpu_torch"):
        got = cli_main._load_records(cfg)
        one = cli_main._load_records(cfg, pans[2:3])
    want = load_cohort(d, pans, FEATURES)
    assert_records_equal(got, want)
    assert_records_equal(one, want[2:3])
    loader = "native" if native else "python"
    n_obs = sum(r.n_obs for r in want)
    assert f"loaded {len(pans)} patients ({n_obs} observations) with the {loader} loader" in caplog.text
