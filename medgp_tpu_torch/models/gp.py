"""Model assembly for the test stage: noiseless gram and noise variance.

Counterpart of the parts of ``medgp_tpu/models/gp.py`` that the test stage
runs. Patients carry an explicit leading batch dimension and share one
flat theta (the fold's mode kernel).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from medgp_tpu_torch.models.params import KernelSpec, LMCSMSpec, SESpec, SMSpec
from medgp_tpu_torch.ops import cuda_gram
from medgp_tpu_torch.ops.gram import gram_se, gram_sm
from medgp_tpu_torch.ops.nlml import mask_gram


class PatientData(NamedTuple):
    """A padded batch of patients; every tensor is (B, n_max)."""

    t: torch.Tensor     # float32 timestamps (hours since admission)
    y: torch.Tensor     # float32 z-normalized observations
    meta: torch.Tensor  # int32 output index in [0, D); 0 on padding
    mask: torch.Tensor  # float32 {0, 1} validity


def noiseless_gram(
    spec: KernelSpec,
    theta: torch.Tensor,
    data: PatientData,
    masked: bool = False,
    plain: bool = False,
) -> torch.Tensor:
    """(B, n, n) noiseless gram of every patient under one theta (H,).

    The LMC-SM gram goes through K1 (`cuda_gram.gram_lmcsm_fused`: the CUDA
    kernel for tensors on the card, its plain twin on the CPU);
    `plain=True` takes the twin on any device. With `masked=True` the
    result carries mask_gram semantics (zero padded rows/cols, unit
    diagonal there), fused into K1's epilogue."""
    p = spec.unpack(theta)
    mask = data.mask if masked else None
    if isinstance(spec, LMCSMSpec):
        Bt = data.t.shape[0]
        B = spec.coregional_B(p["A"], p["kappa"])
        args = (
            data.t, data.meta,
            B.expand(Bt, -1, -1, -1).contiguous(),
            p["mu"].expand(Bt, -1).contiguous(),
            p["v"].expand(Bt, -1).contiguous(),
        )
        if plain:
            return cuda_gram.gram_lmcsm_plain(*args, mask=mask)
        return cuda_gram.gram_lmcsm_fused(*args, mask=mask)
    if isinstance(spec, SESpec):
        K = gram_se(data.t, p["lengthscale"], p["scale"])
    elif isinstance(spec, SMSpec):
        K = gram_sm(data.t, p["w"], p["mu"], p["v"])
    else:
        raise TypeError(f"unsupported spec {spec!r}")
    return K if mask is None else mask_gram(K, mask)


def noise_variance(
    spec: KernelSpec, theta: torch.Tensor, meta: torch.Tensor
) -> torch.Tensor:
    """Per-observation Gaussian noise variance sigma^2: per output for
    LMC-SM (c_likelihood_gaussianMO.cpp:43-65), one sigma^2 for SE/SM."""
    s = spec.unpack(theta)["noise_std"]
    if isinstance(spec, LMCSMSpec):
        return (s**2)[meta.long()]
    return torch.broadcast_to(s[0] ** 2, meta.shape)
