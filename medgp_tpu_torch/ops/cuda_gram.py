"""K1: the batched LMC-SM gram, as a CUDA kernel and its plain twin.

Replaces the Pallas TPU kernel ``medgp_tpu/ops/pallas_gram.py:
_gram_fwd_kernel`` (entry `gram_lmcsm_fused`). The kernel is
``csrc/gram.cuh``; what bounds it and how it is laid out is stated there.

`gram_lmcsm_fused` takes the device of its inputs as the choice: CPU
tensors go to the plain twin `gram_lmcsm_plain`, CUDA tensors to the kernel
(or an error). There is no fallback from the kernel to the twin.
"""

from __future__ import annotations

import torch

from medgp_tpu_torch.ops import cuda_build
from medgp_tpu_torch.ops.gram import gram_lmcsm
from medgp_tpu_torch.ops.nlml import mask_gram

MAX_B_STACK = 8192  # Q*D*D floats the kernel holds in shared memory (gram.cuh)


def gram_lmcsm_plain(t, meta, B, mu, v, mask=None) -> torch.Tensor:
    """Plain PyTorch K1: the batched gram (ops/gram.py), then mask_gram."""
    K = gram_lmcsm(t, meta, B, mu, v)
    return K if mask is None else mask_gram(K, mask)


def gram_lmcsm_fused(t, meta, B, mu, v, mask=None) -> torch.Tensor:
    """(Bt, n) t float32 / meta int32, (Bt, Q, D, D) B, (Bt, Q) mu and v
    [, (Bt, n) mask] -> K (Bt, n, n) float32; with `mask` the mask_gram
    epilogue (zero padded rows/cols, unit diagonal) is fused in."""
    if t.device.type == "cpu":
        return gram_lmcsm_plain(t, meta, B, mu, v, mask)
    if t.device.type != "cuda":
        raise ValueError(f"gram_lmcsm_fused: unsupported device {t.device}")
    Bt, n = t.shape
    Q, D = B.shape[1], B.shape[2]
    dev = t.device
    f32 = torch.float32
    cuda_build.require(t, "t", f32, (Bt, n), dev)
    cuda_build.require(meta, "meta", torch.int32, (Bt, n), dev)
    cuda_build.require(B, "B", f32, (Bt, Q, D, D), dev)
    cuda_build.require(mu, "mu", f32, (Bt, Q), dev)
    cuda_build.require(v, "v", f32, (Bt, Q), dev)
    if mask is not None:
        cuda_build.require(mask, "mask", f32, (Bt, n), dev)
    if Q * D * D > MAX_B_STACK:
        raise ValueError(
            f"gram_lmcsm_fused: Q*D*D = {Q * D * D} exceeds the kernel's "
            f"shared-memory stack of {MAX_B_STACK} floats"
        )
    K = torch.empty((Bt, n, n), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return K
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_gram_lmcsm(
            t.data_ptr(), meta.data_ptr(), B.data_ptr(), mu.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(),
            K.data_ptr(), Bt, n, Q, D, cuda_build.stream_of(t),
        )
    cuda_build.check_launch(code, "gram_lmcsm_fused")
    gram_lmcsm_fused.launches += 1
    return K


gram_lmcsm_fused.launches = 0
