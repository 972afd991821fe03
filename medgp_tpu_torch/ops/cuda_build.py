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
    # t, meta, B, mu, v, mask, K, batch, n, Q, D, stream
    "medgp_gram_lmcsm": [_P] * 7 + [_I] * 4 + [_P],
    # K, noise, y, L, alpha, linvd, batch, n, stream
    "medgp_chol_solve": [_P] * 6 + [_I] * 2 + [_P],
    # L, linvd, X, batch, n, stream
    "medgp_tri_inv": [_P] * 3 + [_I] * 2 + [_P],
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


def build_library() -> tuple[str, float, str]:
    """Compile csrc/*.cu into the library; returns (path, seconds, nvcc's
    output, which lists each kernel's registers and spills)."""
    path = library_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[s for s in _sources() if s.endswith(".cu")]]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, path)  # atomic: a concurrent build never loads a partial file
    return path, seconds, proc.stdout + proc.stderr


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
