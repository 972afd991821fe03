"""Build and load the port's hand-written CUDA kernels.

The sources in ``medgp_tpu_torch/csrc`` (`*.cu` with a plain C interface,
kernels in `*.cuh`) are compiled with nvcc for sm_90a into one shared
library under ``medgp_tpu_torch/build/`` and loaded with ctypes. Nothing
here runs at import: the library is built on first use, named by a hash of
the sources and flags so a stale build is never loaded.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # t, meta, B, mu, v, mask, K, batch, n, Q, D, tile, items_per_cta,
    # ctas, stream
    "medgp_gram_lmcsm": [_P] * 7 + [_I] * 7 + [_P],
    # K, noise, y, L, alpha, linvd, batch, n, cluster, stream
    "medgp_chol_solve": [_P] * 6 + [_I] * 3 + [_P],
    # L, linvd, X, batch, n, stream
    "medgp_tri_inv": [_P] * 3 + [_I] * 2 + [_P],
    # L, linvd, alpha, coef, X, out, batch, n, stream
    "medgp_qmat": [_P] * 6 + [_I] * 2 + [_P],
    # dK, t, meta, B, mu, v, mask, dB_part, dmv_part, dB, dmu, dv,
    # batch, n, Q, D, stream
    "medgp_gram_bwd": [_P] * 12 + [_I] * 4 + [_P],
    # theta, y, meta, mask, the prior's active, exp_tf, ptype, loc, scale,
    # B, mu, v, noise, y_eff, lp, n_eff, batch, n, Q, D, R, prior_stride,
    # stream
    "medgp_theta_prologue": [_P] * 16 + [_I] * 6 + [_P],
    # theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok, the prior's
    # five fields, dtheta, batch, n, Q, D, R, prior_stride, stream
    "medgp_theta_epilogue": [_P] * 16 + [_I] * 6 + [_P],
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in ([home] if home else []) + ["/usr/local/cuda"]:
        cand = os.path.join(root, "bin", "nvcc")
        if os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of medgp_tpu_torch are built from source on first use"
    )


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*")))


def library_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    return os.path.join(BUILD_DIR, f"libmedgp_kernels-{h.hexdigest()[:16]}.so")


def _run_all(cmds):
    """Start every command at once, wait for all; raise on the first that
    failed. Returns their joined output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): {' '.join(c)}\n{out}")
    return "".join(outs)


def build_library() -> tuple[str, float, str]:
    """Compile csrc/*.cu into the library, one nvcc per source started
    together, then link; returns (path, seconds, nvcc's output, which lists
    each kernel's registers and spills)."""
    path = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = f"{path}.{os.getpid()}"
    cu = [s for s in _sources() if s.endswith(".cu")]
    objs = [f"{stem}.{os.path.basename(s)}.o" for s in cu]
    compile_flags = [f for f in NVCC_FLAGS if f != "-shared"]
    tmp = f"{stem}.tmp"
    t0 = time.perf_counter()
    try:
        log = _run_all([[_nvcc(), *compile_flags, "-c", "-o", o, s] for s, o in zip(cu, objs)])
        log += _run_all([[_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs]])
        os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    finally:
        for f in (*objs, tmp):
            if os.path.exists(f):
                os.remove(f)
    seconds = time.perf_counter() - t0
    return path, seconds, log


@functools.cache
def load_library() -> ctypes.CDLL:
    path = library_path()
    if not os.path.exists(path):
        build_library()
    lib = ctypes.CDLL(path)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.medgp_error_string.argtypes = [ctypes.c_int]
    lib.medgp_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        msg = load_library().medgp_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_of(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def require(x: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Validate a kernel argument before its pointer is passed on."""
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(x).__name__}")
    if x.device != device:
        raise ValueError(f"{name}: on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
