// K4 (qmat) for Hopper (sm_90a): the NLML cotangent with respect to the gram,
//
//   out = c * (L^{-T} L^{-1} - alpha alpha^T),
//
// i.e. c * (M^{-1} - alpha alpha^T) for M = L L^T (the reference's Q-matrix,
// medgpc/src/inference/c_inference_exact.cpp:168-172). Replaces the Pallas
// TPU kernel medgp_tpu/ops/pallas_chol.py:_qmat_kernel (pallas_call at
// pallas_chol.py:544), which kept L^{-1} in VMEM scratch and ran the product
// as a 3-pass bf16 MXU contraction.
//
// Two launches (C entry medgp_qmat in chol.cu):
//   1. X = L^{-1} into a workspace by K5's block substitution
//      (chol.cuh:tri_inv_kernel, one CTA per (matrix, 32-wide column block)),
//      from the 32-wide diagonal-block inverses `linvd` that K3 returns;
//   2. qmat_syrk_kernel below: Kinv_ij = sum_{k >= max(i,j)} X_ki X_kj over
//      64x64 tiles of the lower triangle, the rank-1 and scale epilogue, and
//      the mirrored store of the upper triangle, so the output is the full
//      symmetric (n, n) that K2 (the gram backward) takes.
//
// What bounds it on this card: operations. The inverse and the product are
// n^3/3 multiply-adds each per matrix (n = 512: 89 MFLOP), against 8 n^2
// bytes of input and output, so at the batch sizes of training (B >= 128)
// the fp32 CUDA-core rate is the limit, not memory.
//
// What the design does about it: the product is register-tiled, each
// thread holding a 4x4 block of the 64x64 output tile and reading two
// 4-vectors from shared memory per k step (8 loads for 16 FMAs); X is
// lower-triangular with exact zeros above the diagonal, so a tile's k loop
// starts at its own row block and skips the structural zeros; only the
// lower-triangle tiles are computed and each is written twice (directly, and
// transposed through shared memory so both stores are coalesced). The
// workspace X costs one (n, n) round trip through device memory (L2 for a
// few matrices at a time); keeping L^{-1} on chip as the TPU did is later
// work (it does not fit a CTA's shared memory at n = 512).
#pragma once

namespace medgp {

constexpr int kSyTile = 64;                 // output tile (rows and cols)
constexpr int kSyK = 32;                    // k chunk held in shared memory
constexpr int kSyDim = 16;                  // blockDim = (16, 16)
constexpr int kSyThreads = kSyDim * kSyDim;
constexpr int kSyPer = kSyTile / kSyDim;    // 4x4 outputs per thread

__global__ void qmat_syrk_kernel(
    const float* __restrict__ X,      // (batch, n, n) L^{-1}, lower-triangular
    const float* __restrict__ alpha,  // (batch, n)
    const float* __restrict__ coef,   // (batch,)
    float* __restrict__ out,          // (batch, n, n)
    int n) {
  __shared__ float As[kSyK][kSyTile + 4];   // X[k0 + kk][i0 + ii]
  __shared__ float Bs[kSyK][kSyTile + 4];   // X[k0 + kk][j0 + jj]
  __shared__ float Cs[kSyTile][kSyTile + 1];

  // blockIdx.x enumerates the lower-triangle tiles row by row: ti >= tj
  int tj = blockIdx.x, ti = 0;
  while (tj > ti) {
    tj -= ti + 1;
    ++ti;
  }
  const int b = blockIdx.y;
  const int i0 = ti * kSyTile, j0 = tj * kSyTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSyDim + tx;
  const float* Xb = X + (size_t)b * n * n;

  float acc[kSyPer][kSyPer];
#pragma unroll
  for (int r = 0; r < kSyPer; ++r)
#pragma unroll
    for (int c = 0; c < kSyPer; ++c) acc[r][c] = 0.0f;

  // X_ki = 0 for k < i, and i0 >= j0: rows k < i0 add nothing to the tile
  for (int k0 = i0; k0 < n; k0 += kSyK) {
    for (int idx = tid; idx < kSyK * kSyTile; idx += kSyThreads) {
      const int kk = idx / kSyTile, cc = idx % kSyTile;
      const int k = k0 + kk;
      const bool krow = k < n;
      As[kk][cc] = krow && i0 + cc < n ? Xb[(size_t)k * n + i0 + cc] : 0.0f;
      Bs[kk][cc] = krow && j0 + cc < n ? Xb[(size_t)k * n + j0 + cc] : 0.0f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kSyK; ++kk) {
      float a[kSyPer], bb[kSyPer];
#pragma unroll
      for (int r = 0; r < kSyPer; ++r) a[r] = As[kk][ty + kSyDim * r];
#pragma unroll
      for (int c = 0; c < kSyPer; ++c) bb[c] = Bs[kk][tx + kSyDim * c];
#pragma unroll
      for (int r = 0; r < kSyPer; ++r)
#pragma unroll
        for (int c = 0; c < kSyPer; ++c) acc[r][c] += a[r] * bb[c];
    }
    __syncthreads();
  }

  const float cb = coef[b];
  const float* ab = alpha + (size_t)b * n;
  float* ob = out + (size_t)b * n * n;
#pragma unroll
  for (int r = 0; r < kSyPer; ++r) {
    const int rr = ty + kSyDim * r;
    const int i = i0 + rr;
    const float ai = i < n ? ab[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < kSyPer; ++c) {
      const int cc = tx + kSyDim * c;
      const int j = j0 + cc;
      const float aj = j < n ? ab[j] : 0.0f;
      const float val = cb * (acc[r][c] - ai * aj);
      Cs[rr][cc] = val;
      if (i < n && j < n) ob[(size_t)i * n + j] = val;
    }
  }
  if (ti == tj) return;  // a diagonal tile is symmetric and fully written
  __syncthreads();
  // mirrored store: out[j][i] = out[i][j], coalesced along i
  for (int idx = tid; idx < kSyTile * kSyTile; idx += kSyThreads) {
    const int rr = idx / kSyTile, cc = idx % kSyTile;  // row j0 + rr, col i0 + cc
    const int j = j0 + rr, i = i0 + cc;
    if (i < n && j < n) ob[(size_t)j * n + i] = Cs[cc][rr];
  }
}

}  // namespace medgp
