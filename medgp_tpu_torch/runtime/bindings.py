"""ctypes bindings of the port's native cohort loader (runtime/io.cpp).

Counterpart of ``medgp_tpu/runtime/bindings.py``, with the same C ABI and
public names: `native_available`, `count_cohort_native` and
`load_cohort_native`, accelerated equivalents of the Python cohort loader
(`data/cohort.py:load_cohort`) that give the same bits.

The library is built on first use, as ``ops/cuda_build.py`` builds the CUDA
kernels: one compiler call (``$CXX``, else ``g++``) with the JAX package's
Makefile flags, into ``medgp_tpu_torch/build/``, named by a hash of the
compiler, the flags and the source, so that a stale build is never loaded
and nothing is written beside the source. `native_available()` is False
where the compiler is missing or the build or load fails; callers then use
the Python loader.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import logging
import os
import subprocess
from typing import Optional, Sequence

import numpy as np

from medgp_tpu_torch.data import formats
from medgp_tpu_torch.data.cohort import PatientRecord
from medgp_tpu_torch.ops.cuda_build import BUILD_DIR

log = logging.getLogger("medgp_tpu_torch")

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "io.cpp")
# medgp_tpu/runtime/Makefile's CXXFLAGS, and -shared for the library
CXXFLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared"]

_c_long_p = ctypes.POINTER(ctypes.c_long)
_c_int_p = ctypes.POINTER(ctypes.c_int)
_c_float_p = ctypes.POINTER(ctypes.c_float)
_c_double_p = ctypes.POINTER(ctypes.c_double)
_c_str_p = ctypes.POINTER(ctypes.c_char_p)
_SIGNATURES = {
    # data_dir, pan, feature_ids, means, stds, n_features, t, y, meta, cap
    "mgp_load_patient": (ctypes.c_long, [
        ctypes.c_char_p, ctypes.c_char_p, _c_int_p, _c_double_p, _c_double_p,
        ctypes.c_int, _c_float_p, _c_float_p, _c_int_p, ctypes.c_long,
    ]),
    # data_dir, pan, feature_ids, n_features
    "mgp_count_patient": (ctypes.c_long, [
        ctypes.c_char_p, ctypes.c_char_p, _c_int_p, ctypes.c_int,
    ]),
    # data_dir, pans, n_pans, feature_ids, n_features, counts, n_threads
    "mgp_count_cohort": (ctypes.c_int, [
        ctypes.c_char_p, _c_str_p, ctypes.c_int, _c_int_p, ctypes.c_int,
        _c_long_p, ctypes.c_int,
    ]),
    # data_dir, pans, n_pans, feature_ids, means, stds, n_features, offsets,
    # t, y, meta, n_threads
    "mgp_load_cohort": (ctypes.c_int, [
        ctypes.c_char_p, _c_str_p, ctypes.c_int, _c_int_p, _c_double_p,
        _c_double_p, ctypes.c_int, _c_long_p, _c_float_p, _c_float_p,
        _c_int_p, ctypes.c_int,
    ]),
}


def _cxx() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> str:
    h = hashlib.sha256(" ".join([_cxx(), *CXXFLAGS]).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libmedgp_io-{h.hexdigest()[:16]}.so")


def build_library() -> str:
    """Compile io.cpp into the library at `library_path()`; returns it."""
    path = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [_cxx(), *CXXFLAGS, "-o", tmp, SOURCE],
            check=True, capture_output=True, text=True, timeout=120,
        )
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


@functools.cache
def _load() -> Optional[ctypes.CDLL]:
    try:
        path = library_path()
        if not os.path.exists(path):
            build_library()
        lib = ctypes.CDLL(path)
    except subprocess.CalledProcessError as e:
        log.warning("native cohort loader: %s failed:\n%s", _cxx(), e.stderr)
        return None
    except (OSError, subprocess.SubprocessError) as e:
        log.warning("native cohort loader unavailable: %s", e)
        return None
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def native_available() -> bool:
    return _load() is not None


def _library() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(
            "native cohort loader unavailable (see the log for the build "
            "error); use data.cohort.load_cohort"
        )
    return lib


def _c_str_array(strs: Sequence[str]):
    keep = [s.encode() for s in strs]
    arr = (ctypes.c_char_p * len(keep))(*keep)
    return arr, keep


def _fid_array(fids: Sequence[int]):
    a = np.ascontiguousarray(fids, np.int32)
    return a, a.ctypes.data_as(_c_int_p)


def count_cohort_native(
    data_dir: str, pans: Sequence[str], feature_ids: Sequence[int],
    n_threads: int = 0,
) -> np.ndarray:
    """(P,) int64 observation counts, read from the first token of each
    feature file; a missing file counts 0."""
    lib = _library()
    n_threads = n_threads or max(os.cpu_count() or 1, 1)
    pan_arr, _keep = _c_str_array([str(p) for p in pans])
    fids, fid_ptr = _fid_array(feature_ids)
    counts = np.zeros(len(pans), np.int64)
    rc = lib.mgp_count_cohort(
        data_dir.encode(), pan_arr, len(pans), fid_ptr, len(fids),
        counts.ctypes.data_as(_c_long_p), n_threads,
    )
    if rc != 0:
        raise RuntimeError(f"mgp_count_cohort returned {rc}")
    return counts


def load_cohort_native(
    data_dir: str,
    pans: Sequence[str],
    feature_ids: Sequence[int],
    n_threads: int = 0,
) -> list[PatientRecord]:
    """Threaded cohort load; a list of PatientRecord (y normalized by the
    cohort's feature{idx}_stat.bin), as `data.cohort.load_cohort` gives."""
    lib = _library()
    n_threads = n_threads or max(os.cpu_count() or 1, 1)
    stats = [
        formats.read_feature_stat(os.path.join(data_dir, f"feature{fid}_stat.bin"))
        for fid in feature_ids
    ]
    means = np.asarray([m for m, _ in stats], np.float64)
    stds = np.asarray([s for _, s in stats], np.float64)

    counts = count_cohort_native(data_dir, pans, feature_ids, n_threads)
    offsets = np.zeros(len(pans) + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    total = int(offsets[-1])

    t = np.zeros(total, np.float32)
    y = np.zeros(total, np.float32)
    meta = np.zeros(total, np.int32)
    pan_arr, _keep = _c_str_array([str(p) for p in pans])
    fids, fid_ptr = _fid_array(feature_ids)
    rc = lib.mgp_load_cohort(
        data_dir.encode(), pan_arr, len(pans), fid_ptr,
        means.ctypes.data_as(_c_double_p), stds.ctypes.data_as(_c_double_p),
        len(fids), offsets.ctypes.data_as(_c_long_p),
        t.ctypes.data_as(_c_float_p), y.ctypes.data_as(_c_float_p),
        meta.ctypes.data_as(_c_int_p), n_threads,
    )
    if rc != 0:
        raise RuntimeError(
            "mgp_load_cohort: a patient's files hold another count than "
            "their first token says (changed while loading, or unreadable)"
        )
    return [
        PatientRecord(
            pan=str(pan), t=t[lo:hi].copy(), y=y[lo:hi].copy(),
            meta=meta[lo:hi].copy(),
        )
        for pan, lo, hi in zip(pans, offsets[:-1].tolist(), offsets[1:].tolist())
    ]
