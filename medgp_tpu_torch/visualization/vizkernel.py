"""Kernel / clustering visualization (matplotlib, optional).

Counterpart of ``medgp_tpu/visualization/vizkernel.py``, with the same entry
points and file names; the plotting counterpart of the reference's vizkernel
module (medgpc/visualization/vizkernel.py:21-365): KDE-vs-histogram panels,
cluster scatter in (period, lengthscale) space, per-component SM responses,
and B / A / lambda heatmaps. All entry points are no-ops returning None when
matplotlib is unavailable so the compute pipeline never depends on plotting.
The KDE of `plot_kde_hist` runs through the port's `cluster.kde.gaussian_kde`
on `device` (the card unless the caller asks for the CPU); the rest is host
numpy.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _HAS_MPL = True
except ImportError:  # pragma: no cover
    _HAS_MPL = False

from medgp_tpu_torch.cluster.features import sm_response_curve
from medgp_tpu_torch.cluster.kde import gaussian_kde
from medgp_tpu_torch.models.params import LMCSMSpec
from medgp_tpu_torch.visualization.fastkernel import (
    coregional_B, lmcsm_unpack, se_response, sm_response,
)


def _save(fig, out_dir: str, name: str, fig_format: str = "pdf"):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.{fig_format}")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_kde_hist(
    data: np.ndarray, out_dir: str, name: str, title: str = "",
    bins: int = 40, fig_format: str = "pdf", device="cuda",
) -> Optional[str]:
    """Histogram + fitted KDE density (vizkernel.py:21-62); the KDE runs
    on `device`."""
    if not _HAS_MPL:
        return None
    data = np.asarray(data, float).ravel()
    grid = np.linspace(data.min(), data.max() + 1e-9, 512)
    dens = gaussian_kde(data, grid, device=device)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(data, bins=bins, density=True, alpha=0.4)
    ax.plot(grid, dens, lw=2)
    ax.set_title(title or name)
    return _save(fig, out_dir, name, fig_format)


def plot_cluster_scatter(
    period: np.ndarray, lengthscale: np.ndarray, cluster: np.ndarray,
    out_dir: str, name: str = "all_cluster_feature", title: str = "",
    fig_format: str = "pdf",
) -> Optional[str]:
    """(period, lengthscale) scatter colored by cluster (vizkernel.py:65-116)."""
    if not _HAS_MPL:
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    for c in np.unique(cluster):
        sel = cluster == c
        ax.scatter(period[sel], lengthscale[sel], s=12, label=f"cluster {c}")
    ax.set_xlabel("period (hours)")
    ax.set_ylabel("lengthscale (hours)")
    ax.set_xlim(0, 200)
    ax.set_ylim(0, 500)
    ax.legend()
    ax.set_title(title or name)
    return _save(fig, out_dir, name, fig_format)


def plot_1d_kernel(
    krange: np.ndarray, resp: np.ndarray, out_dir: str,
    name: str = "kernel_1d", title: str = "", ylim=(-1.2, 1.2),
    xlabel: str = "distance in time (hour)", ylabel: str = "covariance",
    fig_format: str = "pdf",
) -> Optional[str]:
    """1-D kernel response curve (vizkernel.py:137-168 `plot_1d_kernel`)."""
    if not _HAS_MPL:
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    ax.plot(np.asarray(krange).ravel(), np.asarray(resp).ravel(), lw=3)
    ax.set_xlim(float(np.min(krange)), float(np.max(krange)))
    ax.set_ylim(*ylim)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title or name)
    return _save(fig, out_dir, name, fig_format)


def plot_2d_kernel(
    matrix: np.ndarray, out_dir: str, name: str = "kernel_2d",
    title: str = "", vmin: float = -2.0, vmax: float = 2.0,
    colorbar: bool = True, fig_format: str = "pdf",
) -> Optional[str]:
    """Matrix heatmap (vizkernel.py:171-214 `plot_2d_kernel`) — used for the
    A / lambda / B coregionalization matrices."""
    if not _HAS_MPL:
        return None
    fig, ax = plt.subplots(figsize=(6, 5))
    im = ax.imshow(
        np.asarray(matrix), interpolation="nearest", cmap="RdBu",
        vmin=vmin, vmax=vmax,
    )
    if colorbar:
        fig.colorbar(im, ax=ax, shrink=0.85)
    ax.set_title(title or name)
    return _save(fig, out_dir, name, fig_format)


def plot_one_kernel(
    kernel: str, theta: np.ndarray, out_dir: str,
    prefix: str = "", fig_format: str = "pdf",
    Q: int = 1, D: int = 1, R: int = 1,
    krange: Optional[np.ndarray] = None,
) -> Optional[list]:
    """Per-kernel plot dispatcher (vizkernel.py:119-135 `plot_one_kernel`):
    LMC-SM gets A/lambda/B heatmaps + per-component SM responses; SE/SM get
    their 1-D responses."""
    if not _HAS_MPL:
        return None
    if kernel == "LMC-SM":
        return plot_one_lmcsm(
            LMCSMSpec(Q, D, R), theta, out_dir, prefix, fig_format, krange
        )
    if kernel == "SE":
        return plot_one_se(theta, out_dir, prefix, fig_format, krange)
    if kernel == "SM":
        return plot_one_sm(theta, out_dir, prefix, fig_format, Q, krange)
    raise NotImplementedError(f"kernel {kernel!r}")


def plot_one_lmcsm(
    spec: LMCSMSpec, theta: np.ndarray, out_dir: str,
    prefix: str = "", fig_format: str = "pdf",
    krange: Optional[np.ndarray] = None,
) -> Optional[list]:
    """A-matrix, lambda and B heatmaps + base SM response per component
    (vizkernel.py:223-303 `plot_one_LMCSM`: amin/amax = +-1 for A/lambda,
    bmin/bmax = +-0.2 for B, 0..120 h response grid at 0.1 h)."""
    if not _HAS_MPL:
        return None
    Q, D, R = spec.Q, spec.D, spec.R
    _, A, mu, v, kap = lmcsm_unpack(np.asarray(theta, float), Q, D, R)
    B = coregional_B(A, kap)
    kr = (
        np.arange(0, 1200) / 10.0 if krange is None
        else np.asarray(krange, float).ravel()
    )
    paths = []
    for q in range(Q):
        paths.append(plot_2d_kernel(
            A[q], out_dir, f"{prefix}a_matrix_{q}", vmin=-1.0, vmax=1.0,
            fig_format=fig_format,
        ))
        paths.append(plot_2d_kernel(
            np.diag(kap[q]), out_dir, f"{prefix}lam_matrix_{q}",
            vmin=-1.0, vmax=1.0, fig_format=fig_format,
        ))
        paths.append(plot_2d_kernel(
            B[q], out_dir, f"{prefix}b_matrix_{q}", vmin=-0.2, vmax=0.2,
            fig_format=fig_format,
        ))
        resp = sm_response(kr**2, mu[q], v[q])
        paths.append(plot_1d_kernel(
            kr, resp, out_dir, f"{prefix}sm_1d_{q}", fig_format=fig_format,
        ))
    return paths


def plot_one_se(
    theta: np.ndarray, out_dir: str, prefix: str = "",
    fig_format: str = "pdf", krange: Optional[np.ndarray] = None,
) -> Optional[list]:
    """SE 1-D response (vizkernel.py:306-333 `plot_one_SE`)."""
    if not _HAS_MPL:
        return None
    theta = np.asarray(theta, float)
    kr = (
        np.arange(0, 1200) / 10.0 if krange is None
        else np.asarray(krange, float).ravel()
    )
    resp = se_response(kr**2, np.exp(theta[1]), np.exp(theta[2]))
    return [plot_1d_kernel(
        kr, resp, out_dir, f"{prefix}se_1d", fig_format=fig_format
    )]


def plot_one_sm(
    theta: np.ndarray, out_dir: str, prefix: str = "",
    fig_format: str = "pdf", Q: int = 1,
    krange: Optional[np.ndarray] = None,
) -> Optional[list]:
    """Weighted sum of SM component responses (vizkernel.py:336-365
    `plot_one_SM`)."""
    if not _HAS_MPL:
        return None
    theta = np.asarray(theta, float)
    kr = (
        np.arange(0, 1200) / 10.0 if krange is None
        else np.asarray(krange, float).ravel()
    )
    total = np.zeros_like(kr)
    for q in range(Q):
        w = np.exp(theta[1 + q])
        mu = np.exp(theta[1 + Q + q])
        v = np.exp(theta[1 + 2 * Q + q])
        total = total + w * sm_response(kr**2, mu, v)
    return [plot_1d_kernel(
        kr, total, out_dir, f"{prefix}sm_1d", fig_format=fig_format
    )]


def plot_lmcsm_kernel(
    spec: LMCSMSpec, theta: np.ndarray, out_dir: str,
    prefix: str = "mode_", fig_format: str = "pdf",
) -> Optional[list]:
    """Per-component panels: B heatmap + SM response (vizkernel.py:217-365)."""
    if not _HAS_MPL:
        return None
    theta = np.asarray(theta, float)
    Q, D, R = spec.Q, spec.D, spec.R
    A = theta[D : D + Q * D * R].reshape(Q, D, R)
    mu = np.exp(theta[D + Q * D * R : D + Q * D * R + Q])
    v2 = np.exp(2 * theta[D + Q * (D * R + 1) : D + Q * (D * R + 2)])
    kap = np.exp(theta[D + Q * (D * R + 2) :]).reshape(Q, D)
    paths = []
    for q in range(Q):
        B = A[q] @ A[q].T + np.diag(kap[q])
        fig, axes = plt.subplots(1, 2, figsize=(10, 4))
        im = axes[0].imshow(B, cmap="RdBu_r", vmin=-np.abs(B).max(),
                            vmax=np.abs(B).max())
        fig.colorbar(im, ax=axes[0], shrink=0.8)
        axes[0].set_title(f"B_{q}")
        resp = sm_response_curve(mu[q], v2[q])
        axes[1].plot(np.arange(len(resp)), resp)
        axes[1].set_xlabel("lag (hours)")
        axes[1].set_title(
            f"SM response q={q} (period {1/mu[q]:.1f} h)"
        )
        paths.append(_save(fig, out_dir, f"{prefix}kernel{q}", fig_format))
    return paths
