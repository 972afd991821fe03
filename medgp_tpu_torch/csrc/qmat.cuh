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
// Launches (C entry medgp_qmat in chol.cu):
//   1. X = L^{-1} into a workspace by K5 (chol.cuh: tri_inv_diag_kernel and
//      one tri_inv_level_kernel per doubling level), from the 32-wide
//      diagonal-block inverses `linvd` that K3 returns;
//   2. qmat_syrk_kernel below: Kinv_ij = sum_{k >= max(i,j)} X_ki X_kj over
//      128 x 128 tiles of the lower triangle, the rank-1 and scale
//      epilogue, and the mirrored store of the upper triangle, so the output
//      is the full symmetric (n, n) that K2 (the gram backward) takes.
//
// What bounds it on this card: operations. The inverse and the product are
// n^3/3 multiply-adds each per matrix (n = 512: 89 MFLOP), against 8 n^2
// bytes of input and output, so at the batch sizes of training (B >= 128)
// the fp32 CUDA-core rate is the limit, not memory. (TF32 tensor cores are
// ruled out by the tolerances.)
//
// What the design does about it: each of 256 threads holds an 8 x 8 block
// of the 128 x 128 output tile and reads four float4 from shared memory per
// k step (4 loads for 64 FMAs); the k chunks of 16 rows of X are copied into
// a three-stage cp.async ring, so the copies of the next two chunks overlap
// the FMAs on this one; X is lower-triangular with exact zeros above the
// diagonal, so a tile's k loop starts at its own row block, and each warp
// (16 rows of the tile) skips the FMAs of the chunks above its rows; only the
// lower-triangle tiles are computed, and each is stored twice, directly and
// mirrored, both as float4 stores (the mirror of a thread's 4 consecutive
// rows is 4 consecutive columns). Every element is one FMA chain in
// ascending k fixed by n alone, so the result is deterministic and does not
// depend on the batch. The workspace X costs one (n, n) round trip through
// device memory (L2 for a few matrices at a time); keeping L^{-1} on chip as
// the TPU did does not fit a CTA's shared memory at n = 512.
#pragma once

namespace medgp {

constexpr int kSyTile = 128;                // output tile (rows and cols)
constexpr int kSyK = 16;                    // k chunk (rows of X) per stage
constexpr int kSyStages = 3;                // cp.async ring depth
constexpr int kSyThreads = 256;             // 8 warps of 16 rows each
constexpr int kSyHalf = kSyTile / 2;        // a thread's columns: 4 tx + c, 64 + 4 tx + c
constexpr int kSyStage = kSyK * kSyTile;    // floats of one operand in one stage

__global__ void __launch_bounds__(kSyThreads, 2) qmat_syrk_kernel(
    const float* __restrict__ X,      // (batch, n, n) L^{-1}, lower-triangular
    const float* __restrict__ alpha,  // (batch, n)
    const float* __restrict__ coef,   // (batch,)
    float* __restrict__ out,          // (batch, n, n)
    int n) {
  __shared__ __align__(16) float sm[2 * kSyStages * kSyStage];  // 48 KB
  float* As = sm;                          // As[k][ii] = X[k0 + k][i0 + ii]
  float* Bs = sm + kSyStages * kSyStage;   // Bs[k][jj] = X[k0 + k][j0 + jj]

  // blockIdx.x enumerates the lower-triangle tiles row by row: ti >= tj
  int tj = blockIdx.x, ti = 0;
  while (tj > ti) {
    tj -= ti + 1;
    ++ti;
  }
  const int b = blockIdx.y;
  const int i0 = ti * kSyTile, j0 = tj * kSyTile;
  // warp w holds rows 16 w .. 16 w + 15 of the tile: lane l the 8 rows
  // 16 w + 8 (l / 16) + r and the columns 4 (l % 16) + c, 64 + 4 (l % 16) + c
  const int tid = threadIdx.x, warp = tid / 32, tx = tid % 16;
  const int row0 = 16 * warp + 8 * (tid % 32 / 16);
  const float* Xb = X + (size_t)b * n * n;

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.0f;

  // X_ki = 0 for k < i, and i0 >= j0: rows k < i0 add nothing to the tile,
  // and a warp's FMAs on chunks k < i0 + 16 w would add exact zeros
  const int nk = (n - i0) / kSyK;
  auto load = [&](int stage, int kc) {
    const size_t row = (size_t)(i0 + kc * kSyK) * n;
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 512 chunks per operand: k row q / 32, chunk q % 32
      const int q = tid + kSyThreads * j;
      const int kr = q >> 5, cq = (q & 31) * 4;
      const size_t at = row + (size_t)kr * n;
      const float* base = Xb + at;
      cp_async16(As + stage * kSyStage + kr * kSyTile + cq,
                 i0 + cq < n ? base + i0 + cq : Xb, i0 + cq < n);
      cp_async16(Bs + stage * kSyStage + kr * kSyTile + cq,
                 j0 + cq < n ? base + j0 + cq : Xb, j0 + cq < n);
    }
  };
#pragma unroll
  for (int st = 0; st < kSyStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kSyStages - 2>();
    __syncthreads();  // chunk kc has landed; the stage refilled next was consumed
    if (kc + kSyStages - 1 < nk) load((kc + kSyStages - 1) % kSyStages, kc + kSyStages - 1);
    cp_async_commit();
    if (kc < warp) continue;  // this warp's rows of X are zero in this chunk
    const float* as = As + (kc % kSyStages) * kSyStage;
    const float* bs = Bs + (kc % kSyStages) * kSyStage;
#pragma unroll
    for (int kk = 0; kk < kSyK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kSyTile + row0);
      const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kSyTile + row0 + 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * kSyTile + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + kk * kSyTile + kSyHalf + 4 * tx);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
  cp_async_wait<0>();

  // epilogue: c (Kinv - alpha alpha^T)
  const float cb = coef[b];
  const float* ab = alpha + (size_t)b * n;
  float* ob = out + (size_t)b * n * n;
  int ri[8], cj[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    ri[r] = i0 + row0 + r;
    cj[r] = j0 + (r / 4) * kSyHalf + 4 * tx + r % 4;
  }
  float ai[8], aj[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    ai[r] = ri[r] < n ? ab[ri[r]] : 0.0f;
    aj[r] = cj[r] < n ? ab[cj[r]] : 0.0f;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = cb * (acc[r][c] - ai[r] * aj[c]);
  // n is a multiple of 32, so a group of 4 rows or columns is all in or out
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    if (ri[r] >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (cj[4 * h] < n) {
        *reinterpret_cast<float4*>(ob + (size_t)ri[r] * n + cj[4 * h]) = make_float4(
            acc[r][4 * h], acc[r][4 * h + 1], acc[r][4 * h + 2], acc[r][4 * h + 3]);
      }
    }
  }
  if (ti == tj) return;  // a diagonal tile is symmetric and fully written
  // mirrored store: out[j][i] = out[i][j], four consecutive i per float4
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    if (cj[c] >= n) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (ri[4 * h] < n) {
        *reinterpret_cast<float4*>(ob + (size_t)cj[c] * n + ri[4 * h]) = make_float4(
            acc[4 * h][c], acc[4 * h + 1][c], acc[4 * h + 2][c], acc[4 * h + 3][c]);
      }
    }
  }
}

}  // namespace medgp
