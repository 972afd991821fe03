"""Reference-format artifacts read and written by the train and test stages.

Counterpart of ``medgp_tpu/data/formats.py``, trimmed to what the ported
slices read and write. Every file is byte-compatible with the JAX
package's (and with the reference pipeline's):

  * `*.bin` - raw little-endian float64 arrays;
  * `*_feature_*.txt`, `*_ci_*.txt`, `*_flag_*.txt` - one integer per line;
  * `feature{idx}.txt` - the observation count, then (time, value) pairs;
  * `feature{idx}_stat.bin` - two float64: cohort mean, std;
  * `hyp_bound.txt` - (lb, ub) per hyper, one number per line;
  * `{alg}_mode_param.bin` / `{alg}_mode_mixture_num.txt` - mode kernel.
"""

from __future__ import annotations

import os
from typing import Iterable, Sequence

import numpy as np


# ---------- primitive formats ----------

def write_double_bin(path: str, arr) -> None:
    np.asarray(arr, dtype="<f8").ravel().tofile(path)


def read_double_bin(path: str) -> np.ndarray:
    return np.fromfile(path, dtype="<f8")


def write_int_txt(path: str, arr: Iterable[int]) -> None:
    with open(path, "w") as f:
        for v in np.asarray(list(arr), dtype=np.int64).ravel():
            f.write(f"{int(v)}\n")


def read_int_txt(path: str) -> np.ndarray:
    return np.atleast_1d(np.loadtxt(path, dtype=np.int64))


# ---------- raw patient data ----------

def write_feature_txt(path: str, t: np.ndarray, v: np.ndarray) -> None:
    """One value per line, [n, t1, v1, t2, v2, ...] (the reference ETL's
    layout, jmlr_mimic_heart_failure.py:284-285)."""
    data = np.hstack(
        [[len(t)], np.vstack([np.asarray(t), np.asarray(v)]).T.reshape(-1)]
    )
    np.savetxt(path, data, delimiter="\n", fmt="%6.6f")


def read_feature_txt(path: str):
    """(t, v) arrays; tolerant of any whitespace layout like the C++ `>>`."""
    with open(path) as f:
        arr = np.array(f.read().split(), dtype=np.float64)
    n = int(arr[0])
    body = arr[1 : 1 + 2 * n]
    return body[0::2].copy(), body[1::2].copy()


def write_feature_stat(path: str, mean: float, std: float) -> None:
    write_double_bin(path, np.asarray([mean, std]))


def read_feature_stat(path: str):
    arr = read_double_bin(path)
    return float(arr[0]), float(arr[1])


def load_patient(
    data_dir: str,
    pan: str,
    feature_index: Sequence[int],
):
    """One patient's observations for the configured features: (t, y, meta)
    float32/float32/int32, concatenated feature-major, y normalized by the
    cohort's feature{idx}_stat.bin; meta is the position within
    `feature_index` (c_experiment.cpp:254-309). Missing per-feature files
    contribute no observations."""
    ts, ys, ms = [], [], []
    for j, fidx in enumerate(feature_index):
        fpath = os.path.join(data_dir, str(pan), f"feature{fidx}.txt")
        if not os.path.exists(fpath):
            continue
        t, v = read_feature_txt(fpath)
        mean, std = read_feature_stat(
            os.path.join(data_dir, f"feature{fidx}_stat.bin")
        )
        v = (v - mean) / std
        ts.append(t)
        ys.append(v)
        ms.append(np.full(len(t), j, np.int32))
    if not ts:
        z = np.zeros(0)
        return z.astype(np.float32), z.astype(np.float32), z.astype(np.int32)
    return (
        np.concatenate(ts).astype(np.float32),
        np.concatenate(ys).astype(np.float32),
        np.concatenate(ms).astype(np.int32),
    )


# ---------- bounds ----------

def write_hyp_bounds(path: str, lb: np.ndarray, ub: np.ndarray) -> None:
    with open(path, "w") as f:
        for lo, hi in zip(np.asarray(lb), np.asarray(ub)):
            f.write(f"{lo:6.6f}\n{hi:6.6f}\n")


def read_hyp_bounds(path: str, n_hyp: int):
    """(lb, ub) float64 arrays of the first n_hyp (lb, ub) pairs."""
    vals = np.loadtxt(path, dtype=np.float64).ravel()
    if len(vals) < 2 * n_hyp:
        raise ValueError(
            f"bounds file too short: {path} has {len(vals)} values, "
            f"{2 * n_hyp} needed"
        )
    pairs = vals[: 2 * n_hyp].reshape(n_hyp, 2)
    return pairs[:, 0].copy(), pairs[:, 1].copy()


# ---------- train-stage artifacts ----------

def train_paths(train_dir: str, pan: str) -> dict:
    return dict(
        init=os.path.join(train_dir, f"train_init_hyp_{pan}.bin"),
        hyp=os.path.join(train_dir, f"train_hyp_{pan}.bin"),
        var_hyp=os.path.join(train_dir, f"train_var_hyp_{pan}.bin"),
        num=os.path.join(train_dir, f"train_num_{pan}.txt"),
        flag=os.path.join(train_dir, f"train_flag_{pan}.txt"),
    )


def write_train_result(
    train_dir: str,
    pan: str,
    theta: np.ndarray,
    init_theta: np.ndarray,
    var_state_flat: np.ndarray | None,
    flag: bool,
    n_obs: int,
) -> None:
    """(main_one_train.cpp:257-258, 297-323)"""
    p = train_paths(train_dir, pan)
    write_double_bin(p["init"], init_theta)
    if flag:
        write_double_bin(p["hyp"], theta)
        if var_state_flat is not None and len(var_state_flat):
            write_double_bin(p["var_hyp"], var_state_flat)
    write_int_txt(p["num"], [int(n_obs)])
    write_int_txt(p["flag"], [int(bool(flag))])


def read_train_kernels(train_dir: str, pans: Sequence[str]):
    """Successfully trained hyper vectors, skipping missing or failed
    patients (medgpc/util/binaryIO.py:20-35 `read_train_kernel`).
    Returns (pans (k,), hypers (k, H))."""
    valid_pan, valid_hyp = [], []
    for pan in pans:
        p = train_paths(train_dir, str(pan))
        try:
            flag = int(read_int_txt(p["flag"])[0])
            if flag:
                valid_pan.append(str(pan))
                valid_hyp.append(read_double_bin(p["hyp"]))
        except (OSError, ValueError):
            continue
    return np.asarray(valid_pan), (
        np.asarray(valid_hyp) if valid_hyp else np.zeros((0, 0))
    )


# ---------- test-stage artifacts ----------

def test_paths(test_dir: str, test_mode: str, pan: str) -> dict:
    prefix = os.path.join(test_dir, f"test_{test_mode}_")
    return dict(
        feature=prefix + f"feature_{pan}.txt",
        etime=prefix + f"etime_{pan}.bin",
        ci=prefix + f"ci_{pan}.txt",
        error=prefix + f"error_{pan}.bin",
        pred=prefix + f"pred_{pan}.bin",
        flag=prefix + f"flag_{pan}.txt",
        # predictive variance: the JAX package's extension of the reference
        # artifact set (needed for held-out predictive NLL)
        var=prefix + f"var_{pan}.bin",
    )


def write_test_result(
    test_dir: str,
    test_mode: str,
    pan: str,
    feature_idx: np.ndarray,
    pred: np.ndarray,
    error: np.ndarray,
    ci: np.ndarray,
    etime: np.ndarray,
    flag: bool,
    var: np.ndarray | None = None,
) -> None:
    """(main_one_test.cpp:446-472; `var` is the JAX package's extension)"""
    p = test_paths(test_dir, test_mode, pan)
    if len(pred) > 0:
        write_int_txt(p["feature"], feature_idx)
        write_double_bin(p["etime"], etime)
        write_int_txt(p["ci"], ci)
        write_double_bin(p["error"], error)
        write_double_bin(p["pred"], pred)
        if var is not None:
            write_double_bin(p["var"], var)
    write_int_txt(p["flag"], [int(bool(flag))])


def read_test_result(test_dir: str, test_mode: str, pan: str):
    """(flag, dict | None); `var` is None when the writer did not record it."""
    p = test_paths(test_dir, test_mode, pan)
    flag = int(read_int_txt(p["flag"])[0])
    if not flag:
        return flag, None
    return flag, dict(
        feature=read_int_txt(p["feature"]),
        pred=read_double_bin(p["pred"]),
        ci=read_int_txt(p["ci"]),
        error=read_double_bin(p["error"]),
        etime=read_double_bin(p["etime"]),
        var=(
            read_double_bin(p["var"]) if os.path.exists(p["var"]) else None
        ),
    )


def mode_kernel_paths(kernel_dir: str, fold: int, alg: str) -> dict:
    sub = f"fold{fold}" if fold != -1 else "all"
    d = os.path.join(kernel_dir, sub)
    return dict(
        dir=d,
        param=os.path.join(d, f"{alg}_mode_param.bin"),
        mixture_num=os.path.join(d, f"{alg}_mode_mixture_num.txt"),
    )


def write_mode_kernel(
    kernel_dir: str, fold: int, alg: str, mode_theta: np.ndarray, newQ: int
) -> None:
    p = mode_kernel_paths(kernel_dir, fold, alg)
    os.makedirs(p["dir"], exist_ok=True)
    np.savetxt(p["mixture_num"], [newQ], fmt="%d")
    write_double_bin(p["param"], mode_theta)


def read_mode_kernel(kernel_dir: str, fold: int, alg: str):
    p = mode_kernel_paths(kernel_dir, fold, alg)
    newQ = int(np.loadtxt(p["mixture_num"], dtype=int))
    return read_double_bin(p["param"]), newQ
