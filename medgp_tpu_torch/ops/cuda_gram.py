"""K1 and K2: the batched LMC-SM gram and its VJP, as CUDA kernels and their
plain twins, and the `torch.autograd.Function` that joins them.

Replace the Pallas TPU kernels ``medgp_tpu/ops/pallas_gram.py:
_gram_fwd_kernel`` (entry `gram_lmcsm_fused`) and `_gram_bwd_kernel` (its
custom VJP). The kernels are ``csrc/gram.cuh``; what bounds them and how
they are laid out is stated there.

Each wrapper takes the device of its inputs as the choice: CPU tensors go
to the plain twin, CUDA tensors to the kernel (or an error). There is no
fallback from the kernel to the twin. Every call counts its batch as the
counter `<k>.systems`, and every launch on the card `<k>.launches`, for
k = k1 (K1), k2 (K2); utils/metrics.py.
"""

from __future__ import annotations

import math

import torch

from medgp_tpu_torch.models.params import REF_PI
from medgp_tpu_torch.ops import cuda_build
from medgp_tpu_torch.ops.gram import gram_lmcsm
from medgp_tpu_torch.ops.nlml import mask_gram
from medgp_tpu_torch.utils import metrics

# Shared memory a block may take on the H100 (227 KB), less a reserve for
# the kernels' static arrays (K1 has none, K2 under 4 KB); the C entries
# check the exact figure on the card.
SMEM_BYTES = 232448 - 4096
BWD_BAND = 32    # rows per band of K2's partial sums
BWD_CHUNK = 192  # columns per staged chunk of K2 (gram.cuh kBwdChunk)

# K1's launch plan (gram.cuh gram_lmcsm_kernel): 64x64 tile pairs of the
# lower triangle, 256 threads a CTA, at most 3 CTAs per SM (its
# __launch_bounds__), on the H100 SXM's 132 SMs. A plan aims at four waves
# of CTAs, so that the last, partial wave costs little.
GRAM_TILE = 64
GRAM_SMS = 132
GRAM_CTAS_PER_SM = 3
GRAM_WAVES = 4


def fwd_smem_bytes(Q: int, D: int) -> int:
    """K1's dynamic shared memory (gram.cuh gram_fwd_smem_floats): the cos
    and sin tables of a tile pair's rows and columns, their t, mask and
    meta, the 64x65 staging buffer, per-component constants, eight warp
    minima and the B_q stack."""
    T = GRAM_TILE
    return 4 * (4 * Q * T + 6 * T + T * (T + 1) + 2 * Q + 8 + Q * D * D)


def gram_plan(batch: int, n: int) -> tuple[int, int, int]:
    """K1's launch plan for `batch` matrices of order n -> (tile,
    items_per_cta, ctas). Each matrix has P = T (T + 1) / 2 lower tile
    pairs (T = ceil(n / 64)), and each CTA walks a run of items_per_cta of
    them in one matrix, so ctas = batch * ceil(P / items_per_cta). Runs
    are as long as GRAM_WAVES waves of CTAs allow, and of equal length;
    below that many tile pairs every CTA takes one."""
    T = -(-n // GRAM_TILE)
    pairs = T * (T + 1) // 2
    if batch == 0 or pairs == 0:
        return GRAM_TILE, 1, 0
    target = GRAM_WAVES * GRAM_SMS * GRAM_CTAS_PER_SM
    per = max(1, min(pairs, batch * pairs // target))
    per = -(-pairs // -(-pairs // per))  # the same number of runs, evened out
    return GRAM_TILE, per, batch * -(-pairs // per)


def bwd_smem_bytes(G: int, D: int) -> int:
    """K2's dynamic shared memory for G components per pass at D outputs
    (gram.cuh gram_bwd_smem_floats)."""
    return 4 * (G * D * D + G * D * (BWD_BAND + 1) + BWD_BAND * (BWD_CHUNK + 1)
                + 2 * G * BWD_CHUNK + 4 * BWD_CHUNK + D)


def gram_lmcsm_plain(t, meta, B, mu, v, mask=None) -> torch.Tensor:
    """Plain PyTorch K1: the batched gram (ops/gram.py), then mask_gram."""
    K = gram_lmcsm(t, meta, B, mu, v)
    return K if mask is None else mask_gram(K, mask)


def gram_lmcsm_fused(t, meta, B, mu, v, mask=None) -> torch.Tensor:
    """(Bt, n) t float32 / meta int32, (Bt, Q, D, D) B, (Bt, Q) mu and v
    [, (Bt, n) mask] -> K (Bt, n, n) float32; with `mask` the mask_gram
    epilogue (zero padded rows/cols, unit diagonal) is fused in."""
    metrics.count("k1.systems", t.shape[0])
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
    if fwd_smem_bytes(Q, D) > SMEM_BYTES:
        raise ValueError(
            f"gram_lmcsm_fused: Q = {Q}, D = {D} need {fwd_smem_bytes(Q, D)} "
            f"bytes of shared memory per block (the B_q stack is Q*D*D = "
            f"{Q * D * D} floats), above {SMEM_BYTES}"
        )
    K = torch.empty((Bt, n, n), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return K
    tile, per, ctas = gram_plan(Bt, n)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_gram_lmcsm(
            t.data_ptr(), meta.data_ptr(), B.data_ptr(), mu.data_ptr(),
            v.data_ptr(), None if mask is None else mask.data_ptr(),
            K.data_ptr(), Bt, n, Q, D, tile, per, ctas, cuda_build.stream_of(t),
        )
    cuda_build.check_launch(code, "gram_lmcsm_fused")
    metrics.count("k1.launches")
    return K


def gram_lmcsm_bwd_plain(dK, t, meta, B, mu, v, mask=None):
    """Plain PyTorch K2: the three sums of the Pallas kernel's docstring
    (pallas_gram.py:250-255) with w = dK, or dK * (m m^T) when masked:

        dB_q[d, e] = sum_{meta_i = d, meta_j = e} w_ij k_q,ij
        dmu_q = sum w B_q[meta_i, meta_j] (-2 pi d sin(2 pi mu_q d) E_q)
        dv_q  = sum w B_q[meta_i, meta_j] (-4 pi^2 v_q d^2 k_q)

    -> dB (Bt, Q, D, D), dmu and dv (Bt, Q)."""
    Bt, n = t.shape
    Q, D = B.shape[1], B.shape[2]
    w = dK if mask is None else dK * (mask[:, :, None] * mask[:, None, :])
    d = t[:, :, None] - t[:, None, :]
    rsq = d * d
    oh = torch.nn.functional.one_hot(meta.long(), D).to(dK.dtype)  # (Bt, n, D)
    rows = meta.long()[:, :, None].expand(Bt, n, D)
    cols = meta.long()[:, None, :].expand(Bt, n, n)
    dB, dmu, dv = [], [], []
    for q in range(Q):
        muq, vq = mu[:, q, None, None], v[:, q, None, None]
        E = torch.exp(-2.0 * (REF_PI * vq) ** 2 * rsq)
        arg = 2.0 * REF_PI * muq * d
        kq = torch.cos(arg) * E
        dB.append(oh.mT @ (w * kq) @ oh)
        wc = w * B[:, q].gather(1, rows).gather(2, cols)
        dmu.append(torch.sum(wc * (-2.0 * REF_PI * d * torch.sin(arg) * E), dim=(1, 2)))
        dv.append(torch.sum(wc * (-4.0 * REF_PI**2 * vq * rsq * kq), dim=(1, 2)))
    return torch.stack(dB, 1), torch.stack(dmu, 1), torch.stack(dv, 1)


def gram_lmcsm_bwd(dK, t, meta, B, mu, v, mask=None):
    """The gram's VJP with respect to (B, mu, v): (Bt, n, n) dK, and the
    forward's t, meta, B, mu, v [, mask] -> dB (Bt, Q, D, D), dmu and dv
    (Bt, Q), all float32. dK need not be symmetric."""
    metrics.count("k2.systems", t.shape[0])
    if dK.device.type == "cpu":
        return gram_lmcsm_bwd_plain(dK, t, meta, B, mu, v, mask)
    if dK.device.type != "cuda":
        raise ValueError(f"gram_lmcsm_bwd: unsupported device {dK.device}")
    Bt, n = t.shape
    Q, D = B.shape[1], B.shape[2]
    dev, f32 = dK.device, torch.float32
    dK = dK.contiguous()
    cuda_build.require(dK, "dK", f32, (Bt, n, n), dev)
    cuda_build.require(t, "t", f32, (Bt, n), dev)
    cuda_build.require(meta, "meta", torch.int32, (Bt, n), dev)
    cuda_build.require(B, "B", f32, (Bt, Q, D, D), dev)
    cuda_build.require(mu, "mu", f32, (Bt, Q), dev)
    cuda_build.require(v, "v", f32, (Bt, Q), dev)
    if mask is not None:
        cuda_build.require(mask, "mask", f32, (Bt, n), dev)
    if bwd_smem_bytes(1, D) > SMEM_BYTES:
        raise ValueError(
            f"gram_lmcsm_bwd: D = {D} outputs need {bwd_smem_bytes(1, D)} bytes "
            f"of shared memory per block, above {SMEM_BYTES}"
        )
    dB = torch.empty((Bt, Q, D, D), dtype=f32, device=dev)
    dmu = torch.empty((Bt, Q), dtype=f32, device=dev)
    dv = torch.empty((Bt, Q), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return dB.zero_(), dmu.zero_(), dv.zero_()
    nband = math.ceil(n / BWD_BAND)
    dB_part = torch.empty((Bt, nband, Q, D, D), dtype=f32, device=dev)
    dmv_part = torch.empty((Bt, nband, 2, Q), dtype=f32, device=dev)
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_gram_bwd(
            dK.data_ptr(), t.data_ptr(), meta.data_ptr(), B.data_ptr(),
            mu.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            dB_part.data_ptr(), dmv_part.data_ptr(), dB.data_ptr(),
            dmu.data_ptr(), dv.data_ptr(), Bt, n, Q, D,
            cuda_build.stream_of(dK),
        )
    cuda_build.check_launch(code, "gram_lmcsm_bwd")
    metrics.count("k2.launches")
    return dB, dmu, dv


class GramLMCSM(torch.autograd.Function):
    """K = gram(t, meta, B, mu, v [, mask]) with the gradient through K2.

    Forward: K1; backward: K2 -> (None, None, dB, dmu, dv, None). No
    gradient flows to t, meta or mask: they are observation data
    (pallas_gram.py:407-420, 441-453)."""

    @staticmethod
    def forward(ctx, t, meta, B, mu, v, mask):
        ctx.save_for_backward(t, meta, B, mu, v, mask)
        return gram_lmcsm_fused(t, meta, B, mu, v, mask)

    @staticmethod
    def backward(ctx, dK):
        t, meta, B, mu, v, mask = ctx.saved_tensors
        dB, dmu, dv = gram_lmcsm_bwd(dK, t, meta, B, mu, v, mask)
        return None, None, dB, dmu, dv, None
