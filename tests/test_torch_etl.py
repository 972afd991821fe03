"""The port's MIMIC-III ETL (numpy and the standard library, no pandas)
against the JAX package's pandas ETL, on the same synthetic MIMIC-schema
tables, in memory and as csv.gz files.

Held: the same admission lists and cohort_hadm_match.txt; the float64
stats within 1e-12 relative; every feature file byte-equal where no
CHARTTIME repeats within its admission and signal, and equal as a multiset
of (t, v) pairs where one does (pandas leaves the order of equal times
unspecified; the port keeps the table's order); the selection rules; and a
run with pandas hidden.
"""

import ast
import gzip
import importlib
import os
import sys

import numpy as np
import pandas as pd
import pytest

from medgp_tpu.data import mimic_etl as jax_etl
from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data import mimic_etl as etl
from medgp_tpu_torch.data.cohort import load_cohort

EVENT_COLUMNS = ["HADM_ID", "ITEMID", "CHARTTIME", "VALUENUM"]
REPEAT_HADM, REPEAT_ITEM = 100, 220045  # the long group of repeated times


def _synthetic_mimic(n_adm=4):
    """Tiny MIMIC tables exercising every ETL rule (the tables of
    tests/test_aux.py, built again here)."""
    hadms = list(range(100, 100 + n_adm))
    diagnoses = pd.DataFrame(dict(
        HADM_ID=hadms + [999],
        ICD9_CODE=["4280"] * n_adm + ["401"],  # 999 is not heart failure
    ))
    admissions = pd.DataFrame(dict(
        HADM_ID=hadms + [999],
        ADMITTIME=["2001-01-01 00:00:00"] * (n_adm + 1),
        DISCHARGE_LOCATION=["HOME"] * (n_adm - 1) + ["DEAD/EXPIRED", "HOME"],
        HAS_CHARTEVENTS_DATA=[1] * (n_adm + 1),
    ))
    rows = []
    for hadm in hadms[: n_adm - 1]:
        for (idx, name, item), (lb, ub) in zip(etl.VITAL_ITEMS, etl.VITAL_BOUNDS):
            for k in range(8):
                val = (lb if lb else 0.0) + 0.5 * (ub - (lb or 0.0)) + 0.01 * k
                rows.append((hadm, item, f"2001-01-01 {k+1:02d}:00:00", val))
            rows.append((hadm, item, "2001-01-01 10:00:00", ub + 1000.0))
    chart = pd.DataFrame(rows, columns=EVENT_COLUMNS)
    rows = []
    for hadm in hadms[: n_adm - 1]:
        for idx, name, item in etl.LAB_ITEMS:
            for k in range(6):
                rows.append((hadm, item, f"2001-01-01 {k+2:02d}:30:00", 10.0 + k))
            rows.append((hadm, item, "2001-01-01 09:30:00", -5.0))
    lab = pd.DataFrame(rows, columns=EVENT_COLUMNS)
    return diagnoses, admissions, chart, lab


def _rich_synthetic_mimic(n_adm=5):
    """The edge-rule tables of tests/test_etl_crossrun.py, built again here
    (duplicate charttimes, out-of-bound and NaN values, pre-admission
    events, a death, a non-HF admission, an admission that passes the
    value-QC pass but fails the timed one), plus one group of 18 rows at 3
    repeated CHARTTIMEs and event rows in shuffled table order."""
    hadms = list(range(100, 100 + n_adm))
    diagnoses = pd.DataFrame(dict(
        HADM_ID=hadms + [999, 999],
        ICD9_CODE=["4280", "42822", "4280", "4280", "4280", "401", "V053"],
    ))
    admissions = pd.DataFrame(dict(
        HADM_ID=hadms + [999],
        ADMITTIME=["2001-01-01 00:00:00"] * (n_adm + 1),
        DISCHARGE_LOCATION=["HOME"] * (n_adm - 1) + ["DEAD/EXPIRED", "HOME"],
        HAS_CHARTEVENTS_DATA=[1] * (n_adm + 1),
    ))
    chart_rows, lab_rows = [], []
    for ai, hadm in enumerate(hadms[: n_adm - 1]):
        neg = ai == 3
        day = "2000-12-31" if neg else "2001-01-01"
        for (idx, name, item), (lb, ub) in zip(etl.VITAL_ITEMS, etl.VITAL_BOUNDS):
            for k in range(8):
                val = lb + 0.5 * (ub - lb) + 0.01 * k + 0.001 * ai
                chart_rows.append((hadm, item, f"{day} {k + 1:02d}:00:00", val))
            chart_rows.append((hadm, item, f"{day} 01:00:00", lb + 0.4 * (ub - lb)))
            chart_rows.append((hadm, item, "2001-01-01 10:00:00", ub + 1e3))
            chart_rows.append((hadm, item, "2001-01-01 11:00:00", np.nan))
        for idx, name, item in etl.LAB_ITEMS:
            for k in range(6):
                lab_rows.append(
                    (hadm, item, f"{day} {k + 2:02d}:30:00", 10.0 + k + 0.1 * ai))
            lab_rows.append((hadm, item, "2001-01-01 09:30:00", -5.0))
            lab_rows.append((hadm, item, "2001-01-01 12:30:00", np.nan))
    for k in range(18):
        chart_rows.append((REPEAT_HADM, REPEAT_ITEM,
                           f"2001-01-01 {20 + k % 3:02d}:15:00", 60.0 + k))
    rng = np.random.default_rng(718)
    chart_rows = [chart_rows[i] for i in rng.permutation(len(chart_rows))]
    chart = pd.DataFrame(chart_rows, columns=EVENT_COLUMNS)
    lab = pd.DataFrame(lab_rows, columns=EVENT_COLUMNS)
    return diagnoses, admissions, chart, lab


FIXTURES = {"aux": _synthetic_mimic, "rich": _rich_synthetic_mimic}
TABLES = ("DIAGNOSES_ICD", "ADMISSIONS", "CHARTEVENTS", "LABEVENTS")


@pytest.fixture(scope="module", params=sorted(FIXTURES))
def tables(request):
    return request.param, FIXTURES[request.param]()


def _write_csvs(frames, d):
    os.makedirs(d, exist_ok=True)
    for name, df in zip(TABLES, frames):
        with gzip.open(os.path.join(d, f"{name}.csv.gz"), "wt") as f:
            df.to_csv(f, index=False)
    return str(d)


def _read_file(path):
    with open(path, "rb") as f:
        return f.read()


def assert_same_cohort(port_dir, jax_dir, port_pans, jax_pans):
    """Both ETL outputs hold the same cohort (module doc); returns
    (bitwise-equal stats, files compared as multisets)."""
    assert port_pans == jax_pans
    assert _read_file(os.path.join(port_dir, "cohort_hadm_match.txt")) == _read_file(
        os.path.join(jax_dir, "cohort_hadm_match.txt"))
    bitwise = True
    for fidx in etl.ALL_FEATURE_IDS:
        name = f"feature{fidx}_stat.bin"
        got = formats.read_double_bin(os.path.join(port_dir, name))
        want = formats.read_double_bin(os.path.join(jax_dir, name))
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
        bitwise &= bool(np.array_equal(got, want))
    dirs = sorted(p for p in os.listdir(jax_dir) if p.startswith("hadm_"))
    assert sorted(p for p in os.listdir(port_dir) if p.startswith("hadm_")) == dirs
    multisets = 0
    for pan in dirs:
        for fidx in etl.ALL_FEATURE_IDS:
            name = os.path.join(pan, f"feature{fidx}.txt")
            got = _read_file(os.path.join(port_dir, name))
            want = _read_file(os.path.join(jax_dir, name))
            t, v = formats.read_feature_txt(os.path.join(port_dir, name))
            if len(np.unique(t)) == len(t):
                assert got == want, name
                continue
            multisets += 1
            tj, vj = formats.read_feature_txt(os.path.join(jax_dir, name))
            np.testing.assert_array_equal(t, tj)  # both sorted by time
            a, b = np.lexsort((v, t)), np.lexsort((vj, tj))
            np.testing.assert_array_equal(v[a], vj[b])
    return bitwise, multisets


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_selection_rules(name):
    diagnoses, admissions, *_ = FIXTURES[name]()
    sel = etl.select_heart_failure_admissions(diagnoses, admissions)
    np.testing.assert_array_equal(
        sel, jax_etl.select_heart_failure_admissions(diagnoses, admissions))
    assert 999 not in sel          # not ICD-9 428*
    assert 100 + (5 if name == "rich" else 4) - 1 not in sel  # died
    assert sel.dtype == np.int64 and np.all(np.diff(sel) > 0)


def test_extract_cohort_matches_jax(tables, tmp_path):
    name, frames = tables
    port_pans = etl.extract_cohort(*frames, str(tmp_path / "port"))
    jax_pans = jax_etl.extract_cohort(*frames, str(tmp_path / "jax"))
    bitwise, multisets = assert_same_cohort(
        str(tmp_path / "port"), str(tmp_path / "jax"), port_pans, jax_pans)
    assert bitwise  # the same float64 values in the same order: the same sums
    # the rich tables repeat a time in every group of the cohort
    assert multisets == (0 if name == "aux" else 3 * len(etl.VITAL_ITEMS))
    if name == "rich":
        assert len(port_pans) == 3  # 5 HF - 1 died - 1 negative-time removal
        assert os.path.isdir(tmp_path / "port" / "hadm_103")  # files of the removed


def test_extract_cohort_from_csvs_matches_jax(tables, tmp_path):
    name, frames = tables
    mimic = _write_csvs(frames, tmp_path / "mimic")
    port_pans = etl.extract_cohort_from_csvs(mimic, str(tmp_path / "port"))
    jax_pans = jax_etl.extract_cohort_from_csvs(mimic, str(tmp_path / "jax"))
    # pandas' default float parser is off by one ulp on some 17-digit
    # VALUENUM texts, numpy's is correctly rounded: the stats may then
    # differ in their last bit (ROADMAP §C)
    assert_same_cohort(
        str(tmp_path / "port"), str(tmp_path / "jax"), port_pans, jax_pans)


def test_end_to_end_loadable(tmp_path):
    pans = etl.extract_cohort(*_synthetic_mimic(), str(tmp_path))
    assert pans == [f"hadm_{h}" for h in (100, 101, 102)]
    t, v = formats.read_feature_txt(str(tmp_path / pans[0] / "feature0.txt"))
    assert len(t) == 8  # the out-of-bounds draw was QC'd away
    assert np.all(v <= etl.VITAL_BOUNDS[0][1]) and np.all(t > 0)
    recs = load_cohort(str(tmp_path), pans, etl.ALL_FEATURE_IDS)
    assert all(r.n_obs == 8 * 4 + 6 * 20 for r in recs)


def test_repeated_times_keep_table_order(tmp_path):
    """The 18-row group of 3 repeated times: sorted by time, and among
    equal times in the order of the (shuffled) table; the JAX package
    holds the same pairs, in an order of pandas' choosing."""
    frames = _rich_synthetic_mimic()
    etl.extract_cohort(*frames, str(tmp_path / "port"))
    jax_etl.extract_cohort(*frames, str(tmp_path / "jax"))
    chart = frames[2]
    g = chart[(chart.HADM_ID == REPEAT_HADM) & (chart.ITEMID == REPEAT_ITEM)]
    g = g[g.CHARTTIME.str.startswith("2001-01-01 2")]
    assert len(g) == 18
    hours = np.asarray([int(c[11:13]) + 0.25 for c in g.CHARTTIME])
    want = np.asarray(g.VALUENUM)[np.argsort(hours, kind="stable")]
    rel = os.path.join(f"hadm_{REPEAT_HADM}", "feature1.txt")
    t, v = formats.read_feature_txt(str(tmp_path / "port" / rel))
    late = t >= 20
    np.testing.assert_array_equal(t[late], np.sort(hours))
    np.testing.assert_array_equal(v[late], want)
    tj, vj = formats.read_feature_txt(str(tmp_path / "jax" / rel))
    np.testing.assert_array_equal(np.sort(vj[tj >= 20]), np.sort(want))


def test_module_imports_no_pandas():
    tree = ast.parse(open(etl.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]
    assert not [m for m in names if m and m.split(".")[0] in ("pandas", "jax", "medgp_tpu")]


def test_runs_without_pandas(tmp_path, monkeypatch):
    """With pandas hidden from the import system, the port's ETL imports
    and runs, from csv.gz files and from tables of numpy arrays, and
    writes what it writes with pandas present."""
    frames = _rich_synthetic_mimic()
    mimic = _write_csvs(frames, tmp_path / "mimic")
    want = etl.extract_cohort_from_csvs(mimic, str(tmp_path / "with"))
    arrays = [{c: np.asarray(df[c]) for c in df.columns} for df in frames]
    monkeypatch.setitem(sys.modules, "pandas", None)
    with pytest.raises(ImportError):
        import pandas  # noqa: F401
    fresh = importlib.reload(etl)
    try:
        got = fresh.extract_cohort_from_csvs(mimic, str(tmp_path / "csv"))
        got_arrays = fresh.extract_cohort(*arrays, str(tmp_path / "arrays"))
    finally:
        monkeypatch.undo()
        importlib.reload(etl)
    assert got == got_arrays == want
    for out in ("csv", "arrays"):
        for root, _, files in os.walk(tmp_path / "with"):
            for f in files:
                rel = os.path.relpath(os.path.join(root, f), tmp_path / "with")
                assert _read_file(os.path.join(root, f)) == _read_file(
                    tmp_path / out / rel), (out, rel)
