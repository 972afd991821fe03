"""MIMIC-III heart-failure cohort extraction, in numpy and the standard library.

Counterpart of ``medgp_tpu/data/mimic_etl.py`` without pandas, so that it
runs where numpy alone is installed; the library form of the reference's
ETL script (scripts/jmlr_mimic_heart_failure.py): select heart-failure admissions
(ICD-9 428*), exclude in-hospital deaths, keep the 24-signal feature set
(4 vitals + 20 labs) with the reference's QC bounds, require >= 5 QC'd
observations per signal, and emit the raw-data directory tree the whole
pipeline consumes: per-admission feature{idx}.txt (hours since admission,
value), cohort feature{idx}_stat.bin (mean, std of QC'd values), and
cohort_hadm_match.txt.

`extract_cohort` takes its four tables as mappings from column name to
array-like (a dict of numpy arrays, or a pandas DataFrame), so that
``np.asarray(table["HADM_ID"])`` works; text columns may hold the CSV's
strings, an empty field being missing. `extract_cohort_from_csvs` streams
the MIMIC-III csv(.gz) files with the `csv` module and keeps, before any
other per-row work, only the event rows of the 24 ITEMIDs, then only those
of the selected admissions: CHARTEVENTS has about 330 million rows.

One documented difference from the JAX module: each admission's events are
sorted by CHARTTIME stably, so that rows with equal times keep their order
in the table; pandas' `sort_values` leaves their order unspecified. The GP
and the online test treat equal timestamps as one step.
"""

from __future__ import annotations

import csv
import gzip
import itertools
import logging
import os
from typing import Dict, List, Mapping, Tuple

import numpy as np

from medgp_tpu_torch.data import formats

log = logging.getLogger("medgp_tpu_torch")

# (feature_index, name, MIMIC ITEMID); vitals come from CHARTEVENTS with
# two-sided QC bounds, labs from LABEVENTS with a positive-value filter.
VITAL_ITEMS: List[Tuple[int, str, int]] = [
    (0, "RR", 220210),
    (1, "HR", 220045),
    (3, "SBP", 220179),
    (4, "Temp", 223761),
]
VITAL_BOUNDS: List[Tuple[float, float]] = [
    (0.0, 70.0),
    (0.0, 300.0),
    (0.0, 260.0),
    (90.0, 110.0),
]
LAB_ITEMS: List[Tuple[int, str, int]] = [
    (6, "BUN", 51006), (7, "CO2", 50804), (8, "Calcium", 50893),
    (9, "Chloride", 50902), (10, "Creatinine", 50912), (12, "Glucose", 50931),
    (13, "Hct", 51221), (14, "Hgb", 51222), (15, "MCH", 51248),
    (16, "MCHC", 51249), (17, "MCV", 51250), (18, "INR", 51237),
    (19, "PT", 51274), (20, "PTT", 51275), (21, "Platelet", 51265),
    (22, "Potassium", 50971), (23, "RBC", 51279), (24, "RDW", 51277),
    (25, "Sodium", 50983), (26, "WBC", 51301),
]
SAMPLE_THRESHOLD = 5  # minimum QC'd observations per signal per admission

ALL_FEATURE_IDS = [i for i, _, _ in VITAL_ITEMS] + [
    i for i, _, _ in LAB_ITEMS
]

_EVENT_COLUMNS = ("HADM_ID", "ITEMID", "CHARTTIME", "VALUENUM")
_EVENT_CHUNK = 1 << 16  # rows of an event file filtered per list


def _strings(col) -> np.ndarray:
    return np.asarray(col).astype(str)


def _numbers(col) -> np.ndarray:
    """float64 of a numeric column or of its text; an empty field is NaN,
    as pandas reads it."""
    a = np.asarray(col)
    if a.dtype.kind in "biuf":
        return a.astype(np.float64)
    a = a.astype(str)
    return np.where(a == "", "nan", a).astype(np.float64)


def _times(col) -> np.ndarray:
    """datetime64[s] of a datetime column or of "YYYY-MM-DD HH:MM:SS" text;
    an empty field is NaT."""
    a = np.asarray(col)
    if a.dtype.kind != "M":
        a = a.astype(str)
        a = np.where((a == "") | (a == "nan"), "NaT", a)
    return a.astype("datetime64[s]")


def select_heart_failure_admissions(
    diagnoses: Mapping, admissions: Mapping
) -> np.ndarray:
    """HADM_IDs with any ICD-9 428* diagnosis, surviving to discharge, with
    chart data (jmlr_mimic_heart_failure.py:79-97); sorted int64."""
    icd = _strings(diagnoses["ICD9_CODE"])
    hf = _numbers(diagnoses["HADM_ID"])[np.char.startswith(icd, "428")]
    adm = _numbers(admissions["HADM_ID"])
    keep = (
        np.isin(adm, hf)
        & (_strings(admissions["DISCHARGE_LOCATION"]) != "DEAD/EXPIRED")
        & (_numbers(admissions["HAS_CHARTEVENTS_DATA"]) == 1)
    )
    return np.unique(adm[keep]).astype(np.int64)


def _qc(values: np.ndarray, times: np.ndarray, lb, ub):
    """NaN removal, positive-time filter, then (lb, ub] value bounds
    (jmlr_mimic_heart_failure.py:17-38 `do_qc`)."""
    keep = ~np.isnan(values)
    values, times = values[keep], times[keep]
    keep = times > 0.0
    values, times = values[keep], times[keep]
    if lb is not None:
        keep = values > lb
        values, times = values[keep], times[keep]
    if ub is not None:
        keep = values <= ub
        values, times = values[keep], times[keep]
    return times, values


def _value_qc(values: np.ndarray, lb, ub):
    """NaN removal + value bounds ONLY (no time filter): the rule the
    reference uses for BOTH the first-pass membership count and the
    population statistics (jmlr_mimic_heart_failure.py:146-162, 181-236)."""
    v = values[~np.isnan(values)]
    if lb is not None:
        v = v[v > lb]
    if ub is not None:
        v = v[v <= ub]
    return v


class _Events:
    """An event table's rows of the selected admissions, columnar, with
    each (ITEMID, HADM_ID) group's row indices in table order."""

    def __init__(self, table: Mapping, hadms: np.ndarray):
        hadm = _numbers(table["HADM_ID"])
        rows = np.flatnonzero(np.isin(hadm, hadms))
        hadm = hadm[rows].astype(np.int64)
        item = _numbers(table["ITEMID"])[rows].astype(np.int64)
        self.time = _times(table["CHARTTIME"])[rows]
        self.value = _numbers(table["VALUENUM"])[rows]
        order = np.lexsort((hadm, item))  # stable: table order within
        keys = np.stack([item[order], hadm[order]], 1)
        starts = np.flatnonzero(np.r_[True, np.any(keys[1:] != keys[:-1], 1)])
        self.groups: Dict[int, Dict[int, np.ndarray]] = {}
        for part in np.split(order, starts[1:]):
            if len(part):
                self.groups.setdefault(int(item[part[0]]), {})[int(hadm[part[0]])] = part


def extract_cohort(
    diagnoses: Mapping,
    admissions: Mapping,
    chartevents: Mapping,
    labevents: Mapping,
    out_dir: str,
) -> List[str]:
    """Run the full ETL; returns the final admission id list (hadm_{id}).

    Event tables need columns HADM_ID, ITEMID, CHARTTIME, VALUENUM.

    The reference's TWO-pass structure, as the JAX module keeps it:
      pass 1 (membership + stats): value-QC only, NO time filter —
        admissions need >= SAMPLE_THRESHOLD bound-respecting values per
        signal; population mean/std come from these values over the
        pass-1 cohort in float64, admissions in id order and each one's
        values in table order;
      pass 2 (files): per-admission series in float32 (the reference
        casts before QC), sorted by CHARTTIME (stably), full QC incl. the
        positive-time filter; any admission dropping below the threshold
        here keeps its feature files on disk but is excluded from
        cohort_hadm_match.txt (the reference's qc_remove_hadm, :245-333).
    """
    os.makedirs(out_dir, exist_ok=True)
    hadms = select_heart_failure_admissions(diagnoses, admissions)

    admit_time = dict(zip(
        _numbers(admissions["HADM_ID"]).astype(np.int64).tolist(),
        _times(admissions["ADMITTIME"]),
    ))
    chart = _Events(chartevents, hadms)
    lab = _Events(labevents, hadms)

    specs = [
        (idx, name, item, lb, ub, chart)
        for (idx, name, item), (lb, ub) in zip(VITAL_ITEMS, VITAL_BOUNDS)
    ] + [(idx, name, item, 0.0, None, lab) for idx, name, item in LAB_ITEMS]

    # ---- pass 1: membership on value-QC'd counts (no time filter) ----
    raw_values: Dict[int, Dict[int, np.ndarray]] = {}
    for idx, name, item, lb, ub, events in specs:
        for hadm, rows in events.groups.get(item, {}).items():
            raw_values.setdefault(hadm, {})[idx] = events.value[rows]
    first_pass = [
        int(h)
        for h in hadms
        if all(
            len(_value_qc(raw_values.get(int(h), {}).get(idx, np.zeros(0)),
                          lb, ub)) >= SAMPLE_THRESHOLD
            for idx, name, item, lb, ub, events in specs
        )
    ]

    # ---- population stats: value-QC'd values over the pass-1 cohort ----
    for idx, name, item, lb, ub, events in specs:
        vals = [
            _value_qc(raw_values[h][idx], lb, ub)
            for h in first_pass
            if idx in raw_values.get(h, {})
        ]
        allv = np.concatenate(vals) if vals else np.zeros(1)
        formats.write_feature_stat(
            os.path.join(out_dir, f"feature{idx}_stat.bin"),
            float(np.nanmean(allv)), float(np.nanstd(allv)),
        )

    # ---- pass 2: per-admission float32 series with the full QC ----
    series: Dict[int, Dict[int, Tuple[np.ndarray, np.ndarray]]] = {}
    for idx, name, item, lb, ub, events in specs:
        groups = events.groups.get(item, {})
        for hadm in first_pass:
            if hadm not in groups:
                continue
            rows = groups[hadm]
            rows = rows[np.argsort(events.time[rows], kind="stable")]
            # integer-second difference then float32 hours: the reference's
            # (charttime - ref)/1e9 -> f32 /3600 chain
            dt = events.time[rows] - admit_time[hadm]
            sec = np.where(np.isnat(dt), np.nan, dt.astype(np.float64))
            t = sec.astype(np.float32) / np.float32(3600.0)
            v = events.value[rows].astype(np.float32)
            series.setdefault(hadm, {})[idx] = _qc(v, t, lb, ub)

    qc_removed = set()
    for hadm in first_pass:
        per = series.get(hadm, {})
        for idx, *_ in specs:
            if len(per.get(idx, ((), ()))[0]) < SAMPLE_THRESHOLD:
                qc_removed.add(hadm)
                break

    # feature files for EVERY pass-1 admission (reference writes the dirs
    # before deciding qc_remove_hadm); the id list excludes the removed
    pans = []
    for hadm in first_pass:
        pan = f"hadm_{hadm}"
        pdir = os.path.join(out_dir, pan)
        os.makedirs(pdir, exist_ok=True)
        for idx, *_ in specs:
            t, v = series.get(hadm, {}).get(
                idx, (np.zeros(0, np.float32), np.zeros(0, np.float32))
            )
            formats.write_feature_txt(
                os.path.join(pdir, f"feature{idx}.txt"), t, v
            )
        if hadm not in qc_removed:
            pans.append(pan)

    with open(os.path.join(out_dir, "cohort_hadm_match.txt"), "w") as f:
        for pan in pans:
            f.write(pan + "\n")
    return pans


def _open_text(path: str):
    if path.endswith(".gz"):
        return gzip.open(path, "rt", newline="")
    return open(path, newline="")


def _read_columns(path: str, columns) -> Dict[str, np.ndarray]:
    """The named columns of a (gzipped) CSV file as string arrays."""
    with _open_text(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        at = [header.index(c) for c in columns]
        rows = [[r[i] for i in at] for r in reader]
    cols = list(zip(*rows)) if rows else [()] * len(columns)
    return {c: np.asarray(v, dtype=str) for c, v in zip(columns, cols)}


def _read_events(path: str, hadms: np.ndarray) -> Dict[str, np.ndarray]:
    """_EVENT_COLUMNS of an event file's rows whose ITEMID is one of the 24
    signals' and whose HADM_ID is in `hadms`, streamed: the ITEMID test (a
    set lookup of the field's text) is the only per-row work on the other
    rows."""
    items = {str(i) for _, _, i in VITAL_ITEMS + LAB_ITEMS}
    parts = []
    with _open_text(path) as f:
        reader = csv.reader(f)
        header = next(reader)
        ih, ii, it, iv = (header.index(c) for c in _EVENT_COLUMNS)
        while True:
            line = reader.line_num
            kept = [
                (r[ih], r[ii], r[it], r[iv])
                for r in itertools.islice(reader, _EVENT_CHUNK) if r[ii] in items
            ]
            if kept:
                block = np.asarray(kept, dtype=str)
                parts.append(block[np.isin(_numbers(block[:, 0]), hadms)])
            if reader.line_num == line:
                break
        n_rows = reader.line_num - 1
    block = np.concatenate(parts) if parts else np.zeros((0, 4), str)
    log.info("%s: %d rows read, %d kept", os.path.basename(path), n_rows, len(block))
    return {
        "HADM_ID": _numbers(block[:, 0]).astype(np.int64),
        "ITEMID": _numbers(block[:, 1]).astype(np.int64),
        "CHARTTIME": _times(block[:, 2]),
        "VALUENUM": _numbers(block[:, 3]),
    }


def extract_cohort_from_csvs(mimic_dir: str, out_dir: str) -> List[str]:
    """Run the ETL on the standard MIMIC-III csv.gz files: DIAGNOSES_ICD and
    ADMISSIONS whole, CHARTEVENTS and LABEVENTS streamed (_read_events)."""
    path = lambda name: os.path.join(mimic_dir, name)
    diagnoses = _read_columns(path("DIAGNOSES_ICD.csv.gz"), ("HADM_ID", "ICD9_CODE"))
    admissions = _read_columns(path("ADMISSIONS.csv.gz"), (
        "HADM_ID", "ADMITTIME", "DISCHARGE_LOCATION", "HAS_CHARTEVENTS_DATA"))
    hadms = select_heart_failure_admissions(diagnoses, admissions)
    chart = _read_events(path("CHARTEVENTS.csv.gz"), hadms)
    lab = _read_events(path("LABEVENTS.csv.gz"), hadms)
    return extract_cohort(diagnoses, admissions, chart, lab, out_dir)
