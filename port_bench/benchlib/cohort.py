"""Synthetic cohorts drawn from a seed, on the device.

A frozen copy of the arithmetic of the port's numpy generator
(`medgp_tpu_torch/data/synthetic.py`: `sample_cluster_params`,
`sample_patient`), rewritten as a few large torch calls so that a cohort
of a thousand patients costs set-up seconds, not tens:

  * ground-truth LMC-SM kernels per latent cluster: A ~ 0.4 N(0, 1),
    half of its entries zeroed; period U(12, 72) h, lengthscale
    U(6, 72) h, mu = 1 / period, v = 1 / (2 pi lengthscale);
    kappa U(0.01, 0.05); noise std U(0.15, 0.4);
  * each patient: a cluster, sorted uniform times on [0, t_max), an
    output index per observation (the first 2 D cover every output
    twice: the data-quality gate), and y = L z + noise, L the float64
    Cholesky factor of the cluster's gram (jitter 1e-6 max(1, tr K / n),
    raised tenfold where it fails).

One departure: the lengths are not drawn. Every seed gets the same set,
evenly spaced over [lo, hi), in an order drawn from the seed, so that the
work of a cell does not change from seed to seed.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

REF_PI = 3.14159265  # the model's own constant (medgpc global_settings.h)


@dataclasses.dataclass
class Patient:
    pan: str
    t: np.ndarray     # (n,) float32, sorted
    y: np.ndarray     # (n,) float32
    meta: np.ndarray  # (n,) int32 output index
    cluster: int


def length_set(n_patients: int, lo: int, hi: int) -> np.ndarray:
    """The fixed lengths of a cohort: evenly spaced over [lo, hi)."""
    i = np.arange(n_patients)
    return (lo + np.floor((i + 0.5) * (hi - lo) / n_patients)).astype(np.int64)


def cluster_params(gen: torch.Generator, n_clusters: int, Q: int, D: int, R: int,
                   device) -> dict:
    """Natural parameters of each latent cluster's ground truth, float64,
    with a leading cluster dimension."""
    f64 = dict(dtype=torch.float64, device=device, generator=gen)
    A = torch.randn((n_clusters, Q, D, R), **f64) * 0.4
    A = A * (torch.rand((n_clusters, Q, D, R), **f64) > 0.5)
    period = 12.0 + 60.0 * torch.rand((n_clusters, Q), **f64)
    lscale = 6.0 + 66.0 * torch.rand((n_clusters, Q), **f64)
    kappa = 0.01 + 0.04 * torch.rand((n_clusters, Q, D), **f64)
    noise_std = 0.15 + 0.25 * torch.rand((n_clusters, D), **f64)
    return dict(A=A, mu=1.0 / period, v=1.0 / (2.0 * REF_PI * lscale),
                kappa=kappa, noise_std=noise_std)


def params_to_theta(p: dict) -> torch.Tensor:
    """Natural parameters (leading cluster dimension) -> flat theta
    [log noise | A | log mu | log v | log kappa], float64."""
    C = p["A"].shape[0]
    return torch.cat([
        torch.log(p["noise_std"]).reshape(C, -1), p["A"].reshape(C, -1),
        torch.log(p["mu"]).reshape(C, -1), torch.log(p["v"]).reshape(C, -1),
        torch.log(p["kappa"]).reshape(C, -1),
    ], dim=1)


def _gp_draws(t, meta, valid, c, p, gen, chunk):
    """y = L z + noise for every patient, in chunks of patients padded to
    the longest (identity on the padding)."""
    N, n = t.shape
    D = p["noise_std"].shape[1]
    out = torch.empty((N, n), dtype=torch.float64, device=t.device)
    z = torch.randn((N, n), dtype=torch.float64, device=t.device, generator=gen)
    eps = torch.randn((N, n), dtype=torch.float64, device=t.device, generator=gen)
    for s in range(0, N, chunk):
        sl = slice(s, min(s + chunk, N))
        ts, ms, vs, cs = t[sl].double(), meta[sl].long(), valid[sl], c[sl]
        A, kappa = p["A"][cs], p["kappa"][cs]  # (b, Q, D, R), (b, Q, D)
        B = A @ A.transpose(-1, -2) + torch.diag_embed(kappa)
        oh = torch.nn.functional.one_hot(ms, D).double()  # (b, n, D)
        r = (ts[:, :, None] - ts[:, None, :]).abs()
        K = torch.zeros((ts.shape[0], n, n), dtype=torch.float64, device=t.device)
        for q in range(B.shape[1]):
            kq = torch.cos(2 * REF_PI * r * p["mu"][cs, q, None, None]) * torch.exp(
                -2 * (REF_PI * p["v"][cs, q, None, None]) ** 2 * r * r)
            K += (oh @ B[:, q] @ oh.transpose(-1, -2)) * kq
        vm = vs.double()
        K = K * vm[:, :, None] * vm[:, None, :]
        nv = vm.sum(1)
        jitter = 1e-6 * torch.clamp(torch.diagonal(K, dim1=1, dim2=2).sum(1) / nv, min=1.0)
        eye = torch.eye(n, dtype=torch.float64, device=t.device)
        L = torch.empty_like(K)
        todo = torch.arange(K.shape[0], device=t.device)
        for _ in range(12):
            M = K[todo] + jitter[todo, None, None] * eye * vm[todo, :, None] \
                + torch.diag_embed(1.0 - vm[todo])
            Lt, info = torch.linalg.cholesky_ex(M)
            L[todo] = Lt
            bad = info > 0
            if not bool(bad.any()):
                break
            todo, jitter = todo[bad], jitter.clone()
            jitter[todo] *= 10.0
        else:
            raise np.linalg.LinAlgError("synthetic gram not PSD even with jitter")
        f = (L @ z[sl, :, None])[..., 0]
        y = f + p["noise_std"][cs[:, None], ms] * eps[sl]
        out[sl] = y * vm
    return out


def make_cohort(seed: int, Q: int, D: int, R: int, n_patients: int,
                n_clusters: int, n_obs, t_max: float = 168.0,
                device="cpu", chunk: int = 128, prefix: str = "syn") -> tuple:
    """(patients, cluster thetas (C, H) float64 numpy) of one cohort drawn
    from `seed` on `device`. Patients are ordered as drawn."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    p = cluster_params(gen, n_clusters, Q, D, R, device)
    lens_np = length_set(n_patients, int(n_obs[0]), int(n_obs[1]))
    perm = torch.randperm(n_patients, device=device, generator=gen)
    lens = torch.as_tensor(lens_np, device=device)[perm]
    c = torch.randint(0, n_clusters, (n_patients,), device=device, generator=gen)
    n = int(lens_np.max())
    pos = torch.arange(n, device=device)
    valid = pos[None, :] < lens[:, None]
    u = torch.rand((n_patients, n), dtype=torch.float64, device=device, generator=gen)
    t = torch.where(valid, u * t_max, torch.full_like(u, float("inf")))
    t = torch.sort(t, dim=1).values.float()
    t = torch.where(valid, t, torch.zeros_like(t))
    meta = torch.randint(0, D, (n_patients, n), device=device, generator=gen)
    first = torch.arange(2 * D, device=device) % D
    meta[:, : 2 * D] = first
    meta = torch.where(valid, meta, torch.zeros_like(meta)).int()
    y = _gp_draws(t, meta, valid, c, p, gen, chunk).float()
    t_h, y_h, m_h = t.cpu().numpy(), y.cpu().numpy(), meta.cpu().numpy()
    lens_h, c_h = lens.cpu().numpy(), c.cpu().numpy()
    pats: List[Patient] = []
    for i in range(n_patients):
        k = int(lens_h[i])
        pats.append(Patient(pan=f"{prefix}{i:05d}", t=t_h[i, :k].copy(),
                            y=y_h[i, :k].copy(), meta=m_h[i, :k].copy(),
                            cluster=int(c_h[i])))
    return pats, params_to_theta(p).cpu().numpy()


def interleaved_shards(patients: list, shard_size: int) -> list:
    """Shards of `shard_size` patients with the same spread of lengths:
    the patients sorted by length, shard k taking every k-th."""
    order = sorted(range(len(patients)), key=lambda i: (len(patients[i].t), i))
    k = max(1, len(patients) // shard_size)
    return [[patients[i] for i in order[s::k]] for s in range(k)]
