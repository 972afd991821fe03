"""K3 (`chol_solve`), K5 (`tri_inv`) and K4 (`qmat`): CUDA kernels and
their plain twins.

Replace the Pallas TPU kernels ``medgp_tpu/ops/pallas_chol.py:
_chol_solve_kernel`` (entry `chol_solve`), `_tri_inv_kernel` (entry
`tri_inv`) and `_qmat_kernel` (entry `qmat`). The kernels are in
``csrc/chol.cuh`` and ``csrc/qmat.cuh``, which state what bounds them on
the card and how they are laid out.

Block size: `linvd` holds the inverses of L's 32x32 diagonal blocks, shape
(B, n/32, 32, 32); the TPU kernels' 128-wide superblocks were MXU geometry.
n must be a multiple of BLOCK.

K3 runs each matrix on a thread-block cluster of C CTAs; `chol_cluster_size`
is the launch plan (C from the batch and n alone), and the result does not
depend on C. K5 inverts L by recursive doubling in 1 + ceil(log2(n / 128))
launches (the 128-wide diagonal blocks, then one launch per level); K4 is
those launches into a workspace, then one syrk launch. Their launch plans
live in csrc/chol.cu, and neither result depends on the batch.

Each wrapper takes the device of its inputs as the choice: CPU tensors go
to the plain twin, CUDA tensors to the kernel (or an error), with no
fallback from one to the other.
"""

from __future__ import annotations

import torch

from medgp_tpu_torch.ops import cuda_build

BLOCK = 32
# K3's launch plan: enough CTAs that the batch fills the card's 132 SMs
# twice over, at most 8 CTAs per matrix (the portable cluster size) below
# n = 1024 and 16 (non-portable) from there, and no more than block rows.
CLUSTER_TARGET_CTAS = 2 * 132
CLUSTER_PORTABLE = 8
CLUSTER_MAX = 16


def block_inverses(L: torch.Tensor) -> torch.Tensor:
    """Inverses of the BLOCK x BLOCK diagonal blocks of lower-triangular L,
    (B, n, n) -> (B, n/BLOCK, BLOCK, BLOCK)."""
    Bt, n, _ = L.shape
    nb = n // BLOCK
    blocks = (
        L.reshape(Bt, nb, BLOCK, nb, BLOCK)
        .diagonal(dim1=1, dim2=3)       # (Bt, BLOCK, BLOCK, nb)
        .permute(0, 3, 1, 2)
    )
    eye = torch.eye(BLOCK, dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(
        blocks, eye.expand(Bt, nb, BLOCK, BLOCK), upper=False
    )


def chol_solve_plain(K, noise, y):
    """Plain PyTorch K3. A matrix that is not positive definite
    (`cholesky_ex` info > 0) gets a NaN diagonal, as the kernel's
    non-positive pivot does, so `ops.nlml.chol_ok` and the retry loop
    treat both alike."""
    M = K + torch.diag_embed(noise)
    L, info = torch.linalg.cholesky_ex(M)
    failed = info > 0
    if bool(failed.any()):
        L.diagonal(dim1=-2, dim2=-1)[failed] = float("nan")
    alpha = torch.cholesky_solve(y.unsqueeze(-1), L).squeeze(-1)
    return L, alpha, block_inverses(L)


def tri_inv_plain(L, linvd):
    """Plain PyTorch K5: L^{-1} by triangular solve (`linvd` unused)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)


CLUSTER_DOES_NOT_FIT = -1  # csrc/chol.cu kClusterDoesNotFit


def _check_n(n: int, what: str) -> None:
    if n % BLOCK != 0:
        raise ValueError(f"{what}: n = {n} is not a multiple of {BLOCK}")


def chol_cluster_size(batch: int, n: int) -> int:
    """CTAs per matrix (the cluster size) K3 is launched with for a batch of
    `batch` (n, n) systems: the least power of two C with batch * C >=
    CLUSTER_TARGET_CTAS, capped by CLUSTER_PORTABLE (n < 1024) or
    CLUSTER_MAX, and by the n / BLOCK block rows. So C = 1 for the test
    stage's batches of thousands, and grows for small batches and large n."""
    _check_n(n, "chol_cluster_size")
    cap = min(CLUSTER_MAX if n >= 1024 else CLUSTER_PORTABLE, max(n // BLOCK, 1))
    c = 1
    while 2 * c <= cap and batch * c < CLUSTER_TARGET_CTAS:
        c *= 2
    return c


def chol_solve(K, noise, y):
    """(B, n, n) K, (B, n) noise, (B, n) y -> (L, alpha, linvd):
    L = chol(K + diag(noise)), alpha = (K + diag(noise))^{-1} y and the
    inverses of L's diagonal blocks. Only K's lower triangle is read."""
    Bt, n, _ = K.shape
    _check_n(n, "chol_solve")
    if K.device.type == "cpu":
        return chol_solve_plain(K, noise, y)
    return chol_solve_cluster(K, noise, y, chol_cluster_size(Bt, n))


def chol_solve_cluster(K, noise, y, cluster: int):
    """K3 on the card with `cluster` CTAs per matrix (`chol_solve` takes
    `chol_cluster_size`; another size gives bitwise the same result)."""
    Bt, n, _ = K.shape
    _check_n(n, "chol_solve")
    if K.device.type != "cuda":
        raise ValueError(f"chol_solve: unsupported device {K.device}")
    if not 1 <= cluster <= CLUSTER_MAX:
        raise ValueError(f"chol_solve: cluster of {cluster} CTAs, expected 1..{CLUSTER_MAX}")
    dev, f32 = K.device, torch.float32
    cuda_build.require(K, "K", f32, (Bt, n, n), dev)
    cuda_build.require(noise, "noise", f32, (Bt, n), dev)
    cuda_build.require(y, "y", f32, (Bt, n), dev)
    L = torch.empty((Bt, n, n), dtype=f32, device=dev)
    alpha = torch.empty((Bt, n), dtype=f32, device=dev)
    linvd = torch.empty((Bt, n // BLOCK, BLOCK, BLOCK), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return L, alpha, linvd
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_chol_solve(
            K.data_ptr(), noise.data_ptr(), y.data_ptr(), L.data_ptr(),
            alpha.data_ptr(), linvd.data_ptr(), Bt, n, cluster,
            cuda_build.stream_of(K),
        )
    if code == CLUSTER_DOES_NOT_FIT:
        raise RuntimeError(
            f"chol_solve: a cluster of {cluster} CTAs does not fit on "
            f"{torch.cuda.get_device_name(dev)} (cudaOccupancyMaxActiveClusters = 0)"
        )
    cuda_build.check_launch(code, "chol_solve")
    chol_solve.launches += 1
    return L, alpha, linvd


chol_solve.launches = 0


def tri_inv(L, linvd):
    """(B, n, n) lower-triangular L and its (B, n/32, 32, 32) diagonal
    block inverses -> L^{-1} (B, n, n), lower-triangular."""
    Bt, n, _ = L.shape
    _check_n(n, "tri_inv")
    if L.device.type == "cpu":
        return tri_inv_plain(L, linvd)
    if L.device.type != "cuda":
        raise ValueError(f"tri_inv: unsupported device {L.device}")
    dev, f32 = L.device, torch.float32
    cuda_build.require(L, "L", f32, (Bt, n, n), dev)
    cuda_build.require(linvd, "linvd", f32, (Bt, n // BLOCK, BLOCK, BLOCK), dev)
    X = torch.empty((Bt, n, n), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return X
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_tri_inv(
            L.data_ptr(), linvd.data_ptr(), X.data_ptr(), Bt, n,
            cuda_build.stream_of(L),
        )
    cuda_build.check_launch(code, "tri_inv")
    tri_inv.launches += 1
    return X


tri_inv.launches = 0


def qmat_plain(L, linvd, alpha, coef):
    """Plain PyTorch K4: coef * ((L L^T)^{-1} - alpha alpha^T) by
    `cholesky_inverse` (`linvd` unused)."""
    c = coef.reshape(-1, 1, 1)
    return c * (torch.cholesky_inverse(L) - alpha[:, :, None] * alpha[:, None, :])


def qmat(L, linvd, alpha, coef):
    """(B, n, n) lower-triangular L, its (B, n/32, 32, 32) diagonal-block
    inverses, (B, n) alpha and (B,) or (B, 1) coef -> the full symmetric
    (B, n, n) coef * (L^{-T} L^{-1} - alpha alpha^T): the NLML cotangent with
    respect to the gram when coef = d_nlml / 2. alpha = 0, coef = 1 gives
    the bare inverse (L L^T)^{-1}."""
    Bt, n, _ = L.shape
    _check_n(n, "qmat")
    coef = coef.reshape(Bt)
    if L.device.type == "cpu":
        return qmat_plain(L, linvd, alpha, coef)
    if L.device.type != "cuda":
        raise ValueError(f"qmat: unsupported device {L.device}")
    dev, f32 = L.device, torch.float32
    cuda_build.require(L, "L", f32, (Bt, n, n), dev)
    cuda_build.require(linvd, "linvd", f32, (Bt, n // BLOCK, BLOCK, BLOCK), dev)
    cuda_build.require(alpha, "alpha", f32, (Bt, n), dev)
    coef = coef.contiguous()
    cuda_build.require(coef, "coef", f32, (Bt,), dev)
    out = torch.empty((Bt, n, n), dtype=f32, device=dev)
    if Bt == 0 or n == 0:
        return out
    X = torch.empty((Bt, n, n), dtype=f32, device=dev)  # L^{-1} workspace
    lib = cuda_build.load_library()
    with torch.cuda.device(dev):
        code = lib.medgp_qmat(
            L.data_ptr(), linvd.data_ptr(), alpha.data_ptr(), coef.data_ptr(),
            X.data_ptr(), out.data_ptr(), Bt, n, cuda_build.stream_of(L),
        )
    cuda_build.check_launch(code, "qmat")
    qmat.launches += 1
    return out


qmat.launches = 0
