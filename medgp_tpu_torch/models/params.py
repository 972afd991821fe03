"""Hyperparameter layout: flat theta vector <-> natural parameters.

Counterpart of ``medgp_tpu/models/params.py``. The flat vector keeps the
reference packing ``[lik | cov | mean]`` with the LMC-SM covariance block

    cov = [ A (Q*D*R, raw) | log mu (Q) | log v (Q) | log kappa (Q*D) ]

(medgpc/src/kernel/c_kernel_LMC_SM.cpp:51-70). Functions take torch tensors
with any leading batch dimensions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

# The reference's low-precision PI is load-bearing for numerical parity
# (reference: medgpc/src/util/global_settings.h:6).
REF_PI = 3.14159265


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """Base class for kernel specifications (static, hashable).

    `mean_kind` ("zero", "const" or "const_mo") only sizes the mean block at
    the tail of theta; the test stage uses the zero mean.
    """

    @property
    def n_lik(self) -> int:
        raise NotImplementedError

    @property
    def n_cov(self) -> int:
        raise NotImplementedError

    @property
    def n_outputs(self) -> int:
        return 1

    @property
    def n_mean(self) -> int:
        kind = getattr(self, "mean_kind", "zero")
        if kind == "zero":
            return 0
        if kind == "const":
            return 1
        if kind == "const_mo":
            return self.n_outputs
        raise ValueError(f"unknown mean_kind {kind!r}")

    @property
    def n_hyp(self) -> int:
        return self.n_lik + self.n_cov + self.n_mean

    def mean_vector(self, theta: torch.Tensor, meta: torch.Tensor):
        """Prior mean at each observation, or None for the zero mean.
        theta (..., H) and meta (..., n) share their leading dimensions."""
        kind = getattr(self, "mean_kind", "zero")
        if kind == "zero":
            return None
        _, _, mean = self.split(theta)
        if kind == "const":
            return mean[..., :1].expand(meta.shape)
        return torch.gather(mean, -1, meta.long())

    def split(self, theta: torch.Tensor):
        """Split flat theta into (lik, cov, mean) raw blocks."""
        lik = theta[..., : self.n_lik]
        cov = theta[..., self.n_lik : self.n_lik + self.n_cov]
        mean = theta[..., self.n_lik + self.n_cov :]
        return lik, cov, mean

    def unpack(self, theta: torch.Tensor) -> Dict[str, Any]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class LMCSMSpec(KernelSpec):
    """Spectral-mixture linear model of coregionalization: Q components,
    D outputs (features), rank R coregional factors A_q (D x R)."""

    Q: int
    D: int
    R: int
    mean_kind: str = "zero"

    @property
    def n_outputs(self) -> int:
        return self.D

    @property
    def n_lik(self) -> int:
        return self.D

    @property
    def n_cov(self) -> int:
        return self.Q * (self.D * self.R + 2 + self.D)

    def unpack(self, theta: torch.Tensor) -> Dict[str, Any]:
        """Flat theta -> natural parameters (exp where the reference
        exp-transforms)."""
        Q, D, R = self.Q, self.D, self.R
        lik, cov, _ = self.split(theta)
        lead = cov.shape[:-1]
        a = cov[..., : Q * D * R].reshape(*lead, Q, D, R)
        mu = torch.exp(cov[..., Q * D * R : Q * D * R + Q])
        v = torch.exp(cov[..., Q * D * R + Q : Q * D * R + 2 * Q])
        kappa = torch.exp(
            cov[..., Q * (D * R + 2) : Q * (D * R + 2 + D)]
        ).reshape(*lead, Q, D)
        noise_std = torch.exp(lik)  # per-output sigma_d
        return dict(A=a, mu=mu, v=v, kappa=kappa, noise_std=noise_std)

    def coregional_B(self, A: torch.Tensor, kappa: torch.Tensor) -> torch.Tensor:
        """B_q = A_q A_q^T + diag(kappa_q), shape (..., Q, D, D)
        (reference: c_kernel_LMC_SM.cpp:72-115)."""
        B = torch.einsum("...qdr,...qer->...qde", A, A)
        eye = torch.eye(self.D, dtype=A.dtype, device=A.device)
        return B + kappa[..., :, :, None] * eye


@dataclasses.dataclass(frozen=True)
class SESpec(KernelSpec):
    """1-D squared exponential: hyp = [log noise | log lengthscale, log scale]."""

    mean_kind: str = "zero"

    @property
    def n_lik(self) -> int:
        return 1

    @property
    def n_cov(self) -> int:
        return 2

    def unpack(self, theta: torch.Tensor) -> Dict[str, Any]:
        lik, cov, _ = self.split(theta)
        return dict(
            noise_std=torch.exp(lik),
            lengthscale=torch.exp(cov[..., 0]),
            scale=torch.exp(cov[..., 1]),
        )


@dataclasses.dataclass(frozen=True)
class SMSpec(KernelSpec):
    """1-D spectral mixture: cov = [log w (Q) | log mu (Q) | log v (Q)]."""

    Q: int
    mean_kind: str = "zero"

    @property
    def n_lik(self) -> int:
        return 1

    @property
    def n_cov(self) -> int:
        return 3 * self.Q

    def unpack(self, theta: torch.Tensor) -> Dict[str, Any]:
        Q = self.Q
        lik, cov, _ = self.split(theta)
        return dict(
            noise_std=torch.exp(lik),
            w=torch.exp(cov[..., :Q]),
            mu=torch.exp(cov[..., Q : 2 * Q]),
            v=torch.exp(cov[..., 2 * Q : 3 * Q]),
        )


def cov_slices(spec: LMCSMSpec):
    """Slices of the LMC-SM blocks inside the flat theta (lik offset
    included), for prior masks and varEM clamping."""
    Q, D, R = spec.Q, spec.D, spec.R
    off = spec.n_lik
    return dict(
        lik=slice(0, off),
        a=slice(off, off + Q * D * R),
        mu=slice(off + Q * D * R, off + Q * D * R + Q),
        v=slice(off + Q * D * R + Q, off + Q * (D * R + 2)),
        kappa=slice(off + Q * (D * R + 2), off + Q * (D * R + 2 + D)),
    )


def theta_from_numpy(
    spec: KernelSpec, theta_np, device: torch.device | str = "cpu"
) -> torch.Tensor:
    """A flat theta from the JAX package or a reference artifact (numpy,
    any float dtype) as the port's float32 tensor on `device`.

    The JAX test stage casts the mode kernel to float32 before unpacking
    (medgp_tpu/parallel/runner.py:717), so `spec.unpack` of the result gives
    the same A, mu, v, kappa and noise_std as `LMCSMSpec.unpack` there."""
    arr = np.asarray(theta_np, dtype=np.float32)
    if arr.shape[-1] != spec.n_hyp:
        raise ValueError(
            f"theta has {arr.shape[-1]} entries; {spec} needs {spec.n_hyp}"
        )
    return torch.tensor(arr, device=device)
