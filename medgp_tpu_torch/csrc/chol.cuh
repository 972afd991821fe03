// K3 (chol_solve) and K5 (tri_inv) for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel medgp_tpu/ops/pallas_chol.py:
// _chol_solve_kernel (+ _diag_block_factor, _combine_inverse; pallas_call at
// pallas_chol.py:337). Per matrix:
//   L     = chol(K + diag(noise)),
//   alpha = (K + diag(noise))^{-1} y   (forward + backward substitution),
//   linvd = inverses of L's 32x32 diagonal blocks (consumed by K5 and K4).
// K5 replaces pallas_chol.py:_tri_inv_kernel (pallas_call at :410):
//   X = L^{-1} from L and linvd by recursive doubling (its own comment below).
//
// What bounds K3 on this card: the serial chain of n/32 block steps, and
// how much of the card one matrix can use. The flops (n^3/3 per matrix, 45
// MFLOP at n = 512) and bytes (8 n^2) are small against 67 TFLOP/s and
// 3.35 TB/s; what costs is that every step waits for the previous one, and
// that a training bucket holds 6-29 matrices on a card of 132 SMs.
//
// What the design does about it:
//   * one thread-block cluster of C CTAs per matrix, in one launch
//     (cudaLaunchKernelEx with a cluster dimension; C is chosen by the
//     wrapper from (batch, n): ops/cuda_chol.py:chol_cluster_size). Block
//     rows of 32 are owned block-cyclically (row block ib by CTA ib % C);
//     each CTA keeps its rows in the output buffer L (device memory,
//     L2-resident at the sizes of training), so no size limit applies;
//   * each block step kb is three phases and two cluster barriers:
//     A. the owner of block row kb factors the 32x32 diagonal block in one
//        warp's registers (lane i holds row i; pivots by shuffle), inverts
//        it (lane c solves column c; that inverse is linvd) and forms
//        z_k = inv(L_kk) y_k;
//     B. after cluster.sync(), every CTA reads inv(L_kk) and z_k from the
//        owner's shared memory (distributed shared memory,
//        cluster.map_shared_rank) and forms its own panel blocks
//        L_ik = A_ik inv(L_kk)^T and y_i -= L_ik z_k;
//     C. after a second cluster.sync(), every CTA updates its own trailing
//        tiles A_ij -= L_ik L_jk^T, reading the peers' panel blocks L_jk
//        from L2 (ld.global.cg), in strips of 32 x 128: each thread holds
//        4 x 4 outputs and reads two 4-vectors from shared memory per k
//        (2 FMAs per shared load); each strip's A values and the next
//        strip's L_jk are loaded into registers ahead of the FMA loop, so
//        the loads' latency overlaps it; three CTAs share an SM;
//   * alpha's forward substitution rides along in phases A and B; the
//     backward substitution L^T alpha = z runs in CTA 0 after a last
//     cluster barrier;
//   * the result does not depend on C or on which CTA owns what: every
//     element is computed by the same code in the same order (the trailing
//     update of an element is one 32-term FMA chain per step, subtracted
//     in step order), so a matrix factored alone, in a batch of 64 or of
//     1,024 gives bitwise the same L, alpha and linvd (chip_smoke.py
//     checks this), and the retry driver's re-factored subsets repeat;
//   * a non-positive (or NaN) pivot becomes NaN, with no clamping and no
//     early exit, so it reaches L's diagonal and the retry loop
//     (ops/nlml.py) sees it, as with the Pallas kernel; L's upper triangle
//     is written as exact zeros and only K's lower triangle is read.
// n must be a multiple of 32; there is no upper bound on n.
#pragma once

#include <cooperative_groups.h>

namespace medgp {

namespace cg = cooperative_groups;

constexpr int kBS = 32;                   // block width (and linvd's)
constexpr int kRowsPerPass = 8;           // blockDim = (32, 8)
constexpr int kCholThreads = kBS * kRowsPerPass;
constexpr int kRowsPerThread = kBS / kRowsPerPass;
constexpr int kStripBlocks = 4;           // column blocks per trailing strip
constexpr int kStrip = kStripBlocks * kBS;
constexpr int kCholMaxCluster = 16;       // non-portable cluster size limit
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

// Phase A, one warp: factor the diagonal block held in T (lower triangle,
// upper zero) in place, write its inverse to Tinv and z = inv(L_kk) yk to z.
__device__ __forceinline__ void factor_diag_block(
    float (*T)[kBS + 1], float (*Tinv)[kBS + 1], float* z, const float* yk,
    int lane) {
  float row[kBS];
#pragma unroll
  for (int c = 0; c < kBS; ++c) row[c] = T[lane][c];
#pragma unroll
  for (int j = 0; j < kBS; ++j) {
    const float d = __shfl_sync(kFullMask, row[j], j);
    const float ljj = d > 0.0f ? sqrtf(d) : quiet_nan();
    if (lane == j) {
      row[j] = ljj;
    } else if (lane > j) {
      row[j] = row[j] / ljj;
    }
#pragma unroll
    for (int c = j + 1; c < kBS; ++c) {
      const float lcj = __shfl_sync(kFullMask, row[j], c);
      if (lane >= c) row[c] -= row[j] * lcj;
    }
  }
#pragma unroll
  for (int c = 0; c < kBS; ++c) T[lane][c] = row[c];
  __syncwarp();
  // inverse of the lower-triangular block: lane c solves column c, kept
  // in Tinv's column c (each lane reads back only what it wrote)
#pragma unroll
  for (int r = 0; r < kBS; ++r) {
    float s = lane == r ? 1.0f : 0.0f;
#pragma unroll
    for (int q = 0; q < r; ++q) s -= T[r][q] * Tinv[q][lane];
    Tinv[r][lane] = lane <= r ? s / T[r][r] : 0.0f;
  }
  __syncwarp();
  const float yl = yk[lane];
  float s = 0.0f;
#pragma unroll
  for (int q = 0; q < kBS; ++q) {
    const float yq = __shfl_sync(kFullMask, yl, q);
    if (q <= lane) s += Tinv[lane][q] * yq;
  }
  z[lane] = s;
}

// grid: batch * C CTAs in clusters of C (one cluster per matrix), block
// (32, 8). L, alpha and linvd are written by several CTAs of a cluster and
// read by others: no __restrict__, and peers' data is read with __ldcg.
__global__ void __launch_bounds__(kCholThreads, 3) chol_solve_kernel(
    const float* __restrict__ K,      // (batch, n, n)
    const float* __restrict__ noise,  // (batch, n)
    const float* __restrict__ y,      // (batch, n)
    float* L,                         // (batch, n, n) out
    float* alpha,                     // (batch, n) out
    float* linvd,                     // (batch, n/32, 32, 32) out
    int n) {
  __shared__ float Tm[kBS][kBS + 1];    // diagonal block, then panel block
  __shared__ float Tinv[kBS][kBS + 1];  // inv(L_kk), read by peers
  __shared__ float zk[kBS];             // z_k, read by peers
  __shared__ float Ti[kBS][kBS + 1];    // this CTA's copy of the owner's inv(L_kk)
  __shared__ float zl[kBS];             // and of z_k
  __shared__ float Ta[kBS][kBS + 1];    // A_ik
  __shared__ float Pi[kBS][kBS + 1];    // Pi[q][r] = L_ik[r][q]
  __shared__ float Pj[kBS][kStrip + 1]; // Pj[q][c] = L_jk[c][q] over a strip
  __shared__ float red[kRowsPerPass][kBS + 1];

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int b = blockIdx.x / C;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBS + tx;
  const int warp = tid >> 5;
  const int NB = n / kBS;
  const float* Kb = K + (size_t)b * n * n;
  const float* nb = noise + (size_t)b * n;
  const float* yb = y + (size_t)b * n;
  float* Lb = L + (size_t)b * n * n;
  float* ab = alpha + (size_t)b * n;
  float* Db = linvd + (size_t)b * NB * kBS * kBS;

  // this CTA's block rows: the lower triangle of K + diag(noise), upper
  // triangle zero; alpha holds y, then z = L^{-1} y, then the solution
  for (int ib = rank; ib < NB; ib += C) {
    for (int r = ib * kBS + ty; r < (ib + 1) * kBS; r += kRowsPerPass) {
      const size_t base = (size_t)r * n;
      for (int c = tx; c < n; c += kBS) {
        float val = 0.0f;
        if (c < r) val = Kb[base + c];
        else if (c == r) val = Kb[base + c] + nb[r];
        Lb[base + c] = val;
      }
    }
    if (tid < kBS) ab[ib * kBS + tid] = yb[ib * kBS + tid];
  }
  __syncthreads();

  for (int kb = 0; kb < NB; ++kb) {
    const int o = kb * kBS;
    const int owner = kb % C;

    // ---- A: the owner factors the diagonal block ----
    if (rank == owner) {
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Tm[r][tx] = Lb[(size_t)(o + r) * n + o + tx];
      }
      __syncthreads();
      if (warp == 0) factor_diag_block(Tm, Tinv, zk, ab + o, tx);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Lb[(size_t)(o + r) * n + o + tx] = Tm[r][tx];
        Db[(size_t)kb * kBS * kBS + r * kBS + tx] = Tinv[r][tx];
      }
      if (tid < kBS) ab[o + tid] = zk[tid];
    }
    __threadfence();
    cluster.sync();

    // ---- B: panel blocks of this CTA's rows below kb ----
    const int first = kb + 1 + ((rank - (kb + 1)) % C + C) % C;
    if (first < NB) {
      const float* rinv = cluster.map_shared_rank(&Tinv[0][0], owner);
      const float* rz = cluster.map_shared_rank(zk, owner);
      for (int idx = tid; idx < kBS * (kBS + 1); idx += kCholThreads) {
        (&Ti[0][0])[idx] = rinv[idx];
      }
      if (tid < kBS) zl[tid] = rz[tid];
      float ta[kRowsPerThread];  // A_ik of the next row block, in flight
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        ta[m] = Lb[(size_t)(first * kBS + ty + m * kRowsPerPass) * n + o + tx];
      }
      for (int ib = first; ib < NB; ib += C) {
        const int oi = ib * kBS;
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) Ta[ty + m * kRowsPerPass][tx] = ta[m];
        __syncthreads();
        if (ib + C < NB) {
#pragma unroll
          for (int m = 0; m < kRowsPerThread; ++m) {
            ta[m] = Lb[(size_t)(oi + C * kBS + ty + m * kRowsPerPass) * n + o + tx];
          }
        }
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int r = ty + m * kRowsPerPass;
          float s = 0.0f;
#pragma unroll
          for (int q = 0; q < kBS; ++q) {
            if (q <= tx) s += Ta[r][q] * Ti[tx][q];
          }
          Tm[r][tx] = s;
          Lb[(size_t)(oi + r) * n + o + tx] = s;
        }
        __syncthreads();
        if (tid < kBS) {
          float s = 0.0f;
#pragma unroll
          for (int c = 0; c < kBS; ++c) s += Tm[tid][c] * zl[c];
          ab[oi + tid] -= s;
        }
      }
    }
    __threadfence();
    cluster.sync();

    // ---- C: trailing update of this CTA's rows, A_ij -= L_ik L_jk^T ----
    // Each strip's A values and the next strip's L_jk are loaded into
    // registers ahead of the FMA loop, so their latency overlaps it.
    for (int ib = first; ib < NB; ib += C) {
      const int oi = ib * kBS;
      __syncthreads();  // Pi / Pj of the previous row block consumed
#pragma unroll
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Pi[tx][r] = Lb[(size_t)(oi + r) * n + o + tx];
      }
      float pn[kStripBlocks][kRowsPerThread];  // L_jk of the next strip
#pragma unroll
      for (int mb = 0; mb < kStripBlocks; ++mb) {
        const int jb = kb + 1 + mb;
#pragma unroll
        for (int m = 0; m < kRowsPerThread; ++m) {
          pn[mb][m] = jb <= ib
              ? __ldcg(&Lb[(size_t)(jb * kBS + ty + m * kRowsPerPass) * n + o + tx])
              : 0.0f;
        }
      }
      for (int jb0 = kb + 1; jb0 <= ib; jb0 += kStripBlocks) {
#pragma unroll
        for (int mb = 0; mb < kStripBlocks; ++mb)
#pragma unroll
          for (int m = 0; m < kRowsPerThread; ++m) {
            Pj[tx][mb * kBS + ty + m * kRowsPerPass] = pn[mb][m];
          }
        float av[kRowsPerThread][kStripBlocks];  // this strip's A values
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const size_t base = (size_t)(oi + ty + kRowsPerPass * i) * n;
#pragma unroll
          for (int m = 0; m < kStripBlocks; ++m) {
            const int jb = jb0 + m;
            av[i][m] = jb <= ib ? Lb[base + jb * kBS + tx] : 0.0f;
          }
        }
        __syncthreads();
        const int nb0 = jb0 + kStripBlocks;
        if (nb0 <= ib) {
#pragma unroll
          for (int mb = 0; mb < kStripBlocks; ++mb) {
            const int jb = nb0 + mb;
#pragma unroll
            for (int m = 0; m < kRowsPerThread; ++m) {
              pn[mb][m] = jb <= ib
                  ? __ldcg(&Lb[(size_t)(jb * kBS + ty + m * kRowsPerPass) * n + o + tx])
                  : 0.0f;
            }
          }
        }
        float acc[kRowsPerThread][kStripBlocks];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int m = 0; m < kStripBlocks; ++m) acc[i][m] = 0.0f;
#pragma unroll 8
        for (int q = 0; q < kBS; ++q) {
          float a[kRowsPerThread], bq[kStripBlocks];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i) a[i] = Pi[q][ty + kRowsPerPass * i];
#pragma unroll
          for (int m = 0; m < kStripBlocks; ++m) bq[m] = Pj[q][tx + kBS * m];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int m = 0; m < kStripBlocks; ++m) acc[i][m] += a[i] * bq[m];
        }
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i) {
          const int r = ty + kRowsPerPass * i;
          const size_t base = (size_t)(oi + r) * n;
#pragma unroll
          for (int m = 0; m < kStripBlocks; ++m) {
            const int jb = jb0 + m;
            if (jb < ib || (jb == ib && tx <= r)) {
              Lb[base + jb * kBS + tx] = av[i][m] - acc[i][m];
            }
          }
        }
        __syncthreads();  // Pj consumed
      }
    }
    __syncthreads();  // this CTA's rows updated before its next phase A
  }

  // every CTA's rows, z and linvd written; no peer reads shared memory after
  __threadfence();
  cluster.sync();
  if (rank != 0) return;

  // ---- backward substitution in CTA 0: L^T alpha = z ----
  for (int kb = NB - 1; kb >= 0; --kb) {
    const int o = kb * kBS;
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};  // row r = o + 32 + ty + 8 (4 u + v) into s[v]
    int r = o + kBS + ty;
    for (; r + 3 * kRowsPerPass < n; r += 4 * kRowsPerPass) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int rv = r + v * kRowsPerPass;
        s[v] += __ldcg(&Lb[(size_t)rv * n + o + tx]) * __ldcg(&ab[rv]);
      }
    }
    for (; r < n; r += kRowsPerPass) {
      s[0] += __ldcg(&Lb[(size_t)r * n + o + tx]) * __ldcg(&ab[r]);
    }
    red[ty][tx] = (s[0] + s[1]) + (s[2] + s[3]);
    __syncthreads();
    if (tid < kBS) {
      float tot = 0.0f;
      for (int q = 0; q < kRowsPerPass; ++q) tot += red[q][tid];
      zl[tid] = __ldcg(&ab[o + tid]) - tot;
    }
    __syncthreads();
    if (tid < kBS) {
      const float* M = Db + (size_t)kb * kBS * kBS;
      float a = 0.0f;
      for (int r = tid; r < kBS; ++r) a += __ldcg(&M[r * kBS + tid]) * zl[r];
      zk[tid] = a;
    }
    __syncthreads();
    if (tid < kBS) ab[o + tid] = zk[tid];
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// K5 (tri_inv): X = L^{-1}, replacing the Pallas TPU kernel
// medgp_tpu/ops/pallas_chol.py:_tri_inv_kernel (pallas_call at :410), and
// K4's first launches (qmat.cuh).
//
// What bounds it on this card: operations, and the length of the chain of
// dependent steps. The inverse is n^3/3 flops per matrix (n = 512: 45
// MFLOP) against 8 n^2 bytes, so at the test stage's batches of thousands
// the fp32 CUDA-core rate is the limit; at a few matrices of n = 2048 or
// 4096 what limits is how much of the card the work can use at once. Block
// substitution (each block row after the one above it) makes one CTA walk
// a chain of n^2 / 2048 tile products, and that CTA sets the kernel's time.
//
// What the design does about it: recursive doubling. Inverted diagonal
// blocks of width w are combined in pairs into blocks of width 2w,
//
//   [L11   0 ]^-1   [ X11   0 ]
//   [L21 L22 ]    = [ X21 X22 ],   X21 = -X22 (L21 X11),
//
// so the chain is log2(n / 32) levels, each of them batched matrix
// products with ample parallelism (the last level holds 3/4 of the
// operations and (n/2)^2 outputs per matrix).
//   * tri_inv_diag_kernel (one launch): one CTA per (matrix, 128-wide
//     diagonal superblock) starts from K3's 32x32 inverses `linvd` and runs
//     levels 32 and 64 in shared memory (X, the L21 blocks and T = L21 X11
//     all on chip, 2x4 and 4x4 outputs per thread), then writes the
//     superblock with float4 stores;
//   * tri_inv_level_kernel (one launch per level w = 128, 256, ..., < n):
//     one thread-block cluster of C CTAs per (matrix, pair, 64-wide column
//     strip of X21). Phase A: T = L21 X11 on the strip, in 128 x 64 tiles
//     (tile t by CTA t % C), stored in X21's own place; a cluster barrier;
//     phase B: X21 = -X22 T in waves of C tiles from the bottom up (a tile
//     reads T's rows above its own end only), each wave summed in
//     registers, then a cluster barrier, then stored over T. Both phases
//     are the same register-tiled product: 128 threads, 8 x 8 outputs
//     each, k chunks of 16 in a three-stage cp.async ring (the next chunks'
//     copies overlap the FMAs), float4 reads from shared memory; a tile's
//     k loop starts (phase A) or ends (phase B) at the structural zeros of
//     its triangular operand, and in phase B each warp (32 rows) skips the
//     FMAs of the chunks past its own last row. The same CTAs write X12 =
//     0. C is chosen per
//     level from (batch, n) by the C entry (chol.cu); launches per call:
//     1 + ceil(log2(n / 128)), i.e. 1, 2, 3, 6 at n = 128, 256, 512, 4096;
//   * deterministic and batch-invariant: every element is one FMA chain in
//     ascending k, fixed by n and its position alone (not by the batch, C
//     or which CTA computes it), with no atomics; the upper triangle is
//     written as exact zeros, and a member whose L and linvd are the
//     identity (the retry driver's stand-in) gets the identity.
// n must be a multiple of 32; there is no upper bound on n.

constexpr int kW0 = 128;                  // diagonal superblock of the first launch
constexpr int kW0Half = kW0 / 2;
constexpr int kDiagThreads = 256;
constexpr int kDiagPitch = kW0 + 1;
constexpr int kHalfPitch = kW0Half + 1;
constexpr int kBSPitch = kBS + 1;
// tri_inv_diag_kernel's dynamic shared memory: X (128 x 128), T and L21 at
// level 64 (64 x 64 each), the two L21 blocks of level 32 (32 x 32 each)
constexpr int kDiagSmemFloats =
    kW0 * kDiagPitch + 2 * kW0Half * kHalfPitch + 2 * kBS * kBSPitch;

constexpr int kLvBM = 128;                // level product tile: rows
constexpr int kLvBN = 64;                 // and columns (the strip width)
constexpr int kLvBK = 16;                 // k chunk
constexpr int kLvStages = 3;              // cp.async ring depth
constexpr int kLvThreads = 128;           // 4 warps of 32 rows, 8 x 8 outputs a thread
constexpr int kLvAPitch = kLvBK + 4;      // A chunk kept row-major, k contiguous
constexpr int kLvAStage = kLvBM * kLvAPitch;
constexpr int kLvBStage = kLvBK * kLvBN;
constexpr int kLvMaxCluster = 8;          // portable cluster size

// 16-byte asynchronous copy global -> shared through L2 (cp.async.cg); when
// `valid` is false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem, bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(s), "l"(gmem), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

__device__ __forceinline__ float lane_of(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// C = A B (kNeg: C = -A B) for an R x Cn block, all three in shared memory,
// kTR x 4 outputs per thread (thread t of nthreads). The k loop of a tile
// skips the structural zeros of the lower-triangular operand: kLowerA, A's
// past the tile's last row; else B's before the tile's first column.
template <int kTR, bool kLowerA, bool kNeg>
__device__ __forceinline__ void smem_product(
    const float* A, int lda, const float* B, int ldb, float* C, int ldc,
    int R, int Cn, int K, int t, int nthreads) {
  const int tiles_c = Cn / 4;
  for (int tile = t; tile < (R / kTR) * tiles_c; tile += nthreads) {
    const int r0 = tile / tiles_c * kTR, c0 = tile % tiles_c * 4;
    const int kb = kLowerA ? 0 : c0;
    const int ke = kLowerA ? min(K, r0 + kTR) : K;
    float acc[kTR][4];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
#pragma unroll 4
    for (int k = kb; k < ke; ++k) {
      float av[kTR], bv[4];
#pragma unroll
      for (int i = 0; i < kTR; ++i) av[i] = kNeg ? -A[(r0 + i) * lda + k] : A[(r0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = B[k * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(r0 + i) * ldc + c0 + j] = acc[i][j];
  }
}

__device__ __forceinline__ void put4(float* dst, float4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// grid: batch * ceil(n / 128) CTAs, one per (matrix, diagonal superblock of
// m = min(128, n - s) rows at s); dynamic shared memory kDiagSmemFloats.
// Writes X's diagonal superblocks (upper triangle zero); the rest of X is
// written by the level launches. Shared X holds only what the products
// read (the diagonal 32-blocks and the lower blocks they compute); the
// upper 32-blocks go to X as zeros directly.
__global__ void __launch_bounds__(kDiagThreads, 2) tri_inv_diag_kernel(
    const float* __restrict__ L,      // (batch, n, n)
    const float* __restrict__ linvd,  // (batch, n/32, 32, 32)
    float* __restrict__ X,            // (batch, n, n) out
    int n) {
  extern __shared__ float dsm[];
  float* Xs = dsm;                              // [128][129]: the superblock of X
  float* Ts = Xs + kW0 * kDiagPitch;            // [64][65]: T = L21 X11
  float* L64 = Ts + kW0Half * kHalfPitch;       // [64][65]: L[s+64+r][s+c]
  float* L32 = L64 + kW0Half * kHalfPitch;      // [2][32][33]: L[s+64p+32+r][s+64p+c]

  const int nsb = (n + kW0 - 1) / kW0;
  const int b = blockIdx.x / nsb;
  const int s = (blockIdx.x % nsb) * kW0;
  const int m = min(kW0, n - s);
  const int tid = threadIdx.x;
  const float* Lb = L + (size_t)b * n * n;
  const float* Db = linvd + (size_t)b * (n / kBS) * kBS * kBS + (size_t)(s / kBS) * kBS * kBS;
  float* Xb = X + (size_t)b * n * n;
  const float4 zero4 = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

  // the diagonal 32-blocks from linvd and the L21 blocks of both levels:
  // every thread's ten float4 loads are issued before any is stored
  constexpr int kQ32 = kBS * kBS / 4;             // float4 per 32 x 32 block
  constexpr int kQ64 = kW0Half * kW0Half / 4;     // float4 per 64 x 64 block
  constexpr int kND = kW0 / kBS * kQ32 / kDiagThreads;
  constexpr int kN64 = kQ64 / kDiagThreads;
  constexpr int kN32 = 2 * kQ32 / kDiagThreads;
  float4 vd[kND], v64[kN64], v32[kN32];
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    const int q = tid + kDiagThreads * j;         // block q / kQ32, element 4 (q % kQ32)
    vd[j] = q / kQ32 < m / kBS
        ? *reinterpret_cast<const float4*>(Db + (size_t)q * 4) : zero4;
  }
#pragma unroll
  for (int j = 0; j < kN64; ++j) {
    const int q = tid + kDiagThreads * j;
    const int r = q / (kW0Half / 4), c = q % (kW0Half / 4) * 4;
    v64[j] = kW0Half + r < m
        ? *reinterpret_cast<const float4*>(Lb + (size_t)(s + kW0Half + r) * n + s + c) : zero4;
  }
#pragma unroll
  for (int j = 0; j < kN32; ++j) {
    const int q = tid + kDiagThreads * j;
    const int p = q / kQ32, r = q / (kBS / 4) % kBS, c = q % (kBS / 4) * 4;
    const int row = kW0Half * p + kBS + r;
    v32[j] = row < m
        ? *reinterpret_cast<const float4*>(Lb + (size_t)(s + row) * n + s + kW0Half * p + c)
        : zero4;
  }
#pragma unroll
  for (int j = 0; j < kND; ++j) {
    const int q = tid + kDiagThreads * j;
    const int o = q / kQ32 * kBS, e = q % kQ32 * 4;
    if (o < m) put4(Xs + (o + e / kBS) * kDiagPitch + o + e % kBS, vd[j]);
  }
#pragma unroll
  for (int j = 0; j < kN64; ++j) {
    const int q = tid + kDiagThreads * j;
    put4(L64 + q / (kW0Half / 4) * kHalfPitch + q % (kW0Half / 4) * 4, v64[j]);
  }
#pragma unroll
  for (int j = 0; j < kN32; ++j) {
    const int q = tid + kDiagThreads * j;
    put4(L32 + (q / kQ32 * kBS + q / (kBS / 4) % kBS) * kBSPitch + q % (kBS / 4) * 4, v32[j]);
  }
  __syncthreads();

  // level 32: pairs (32-blocks 0, 1) and (2, 3), 128 threads of 2 x 4 each
  {
    const int p = tid / (kDiagThreads / 2), t = tid % (kDiagThreads / 2);
    const int a = kW0Half * p;  // block 1 at a, block 2 at a + 32
    const bool pair = a + kBS < m;
    if (pair) {
      smem_product<2, false, false>(L32 + p * kBS * kBSPitch, kBSPitch,
                                    Xs + a * kDiagPitch + a, kDiagPitch,
                                    Ts + p * kBS * kHalfPitch, kHalfPitch,
                                    kBS, kBS, kBS, t, kDiagThreads / 2);
    }
    __syncthreads();
    if (pair) {
      smem_product<2, true, true>(Xs + (a + kBS) * kDiagPitch + a + kBS, kDiagPitch,
                                  Ts + p * kBS * kHalfPitch, kHalfPitch,
                                  Xs + (a + kBS) * kDiagPitch + a, kDiagPitch,
                                  kBS, kBS, kBS, t, kDiagThreads / 2);
    }
    __syncthreads();
  }
  // level 64: one pair (rows 0..63, rows 64..m-1), 4 x 4 each
  if (m > kW0Half) {
    const int m2 = m - kW0Half;
    smem_product<4, false, false>(L64, kHalfPitch, Xs, kDiagPitch, Ts, kHalfPitch,
                                  m2, kW0Half, kW0Half, tid, kDiagThreads);
    __syncthreads();
    smem_product<4, true, true>(Xs + kW0Half * kDiagPitch + kW0Half, kDiagPitch,
                                Ts, kHalfPitch, Xs + kW0Half * kDiagPitch, kDiagPitch,
                                m2, kW0Half, m2, tid, kDiagThreads);
    __syncthreads();
  }
  for (int q = tid; q < kW0 * kW0 / 4; q += kDiagThreads) {
    const int r = q / (kW0 / 4), c = q % (kW0 / 4) * 4;
    if (r >= m || c >= m) continue;
    const float* x = Xs + r * kDiagPitch + c;
    *reinterpret_cast<float4*>(Xb + (size_t)(s + r) * n + s + c) =
        c / kBS > r / kBS ? zero4 : make_float4(x[0], x[1], x[2], x[3]);
  }
}

// Row i (< 8) of thread tid in a level tile: warp w = tid / 32 holds rows
// 32 w .. 32 w + 31, the thread rows (tid / 8) % 4 + 4 i of those.
__device__ __forceinline__ int level_row(int tid, int i) {
  return 32 * (tid / 32) + (tid / 8) % 4 + 4 * i;
}

// acc = sum_{k < K} A[r][k] B[k][c] (kNeg: minus that) for a 128 x 64 tile,
// rows r < rows (the rest read as zeros): A row-major and B row-major, both
// with leading dimension n, K a multiple of kLvBK. Thread tid holds rows
// level_row(tid, i) and columns 4 tx + j, 32 + 4 tx + j (tx = tid % 8; i, j
// < 8 and 4). kLowerA: A[r][k] = 0 for k > r0 + r, so a warp skips the
// FMAs of the k chunks past its last row (exact zeros; the sum is the
// same). Ends with the ring drained and the CTA synchronised, so the
// caller may overwrite what A and B point to.
template <bool kNeg, bool kLowerA>
__device__ __forceinline__ void level_product(
    const float* A, const float* B, int n, int K, int rows, int r0, float* sm,
    float (&acc)[8][8]) {
  float* As = sm;
  float* Bs = sm + kLvStages * kLvAStage;
  const int tid = threadIdx.x, tx = tid % 8;
  const int warp_last = r0 + 32 * (tid / 32) + 31;  // this warp's last row
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  const int nk = K / kLvBK;
  auto load = [&](int stage, int kc) {
    const int k0 = kc * kLvBK;
    float* as = As + stage * kLvAStage;
    float* bs = Bs + stage * kLvBStage;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // 512 chunks of A: row q / 4, k chunk q % 4
      const int q = tid + kLvThreads * j;
      const int r = q >> 2, kq = (q & 3) * 4;
      const bool ok = r < rows;
      cp_async16(as + r * kLvAPitch + kq, A + (size_t)(ok ? r : 0) * n + k0 + kq, ok);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // 256 chunks of B: k row q / 16, column chunk q % 16
      const int q = tid + kLvThreads * j;
      const int kr = q >> 4, cq = (q & 15) * 4;
      cp_async16(bs + kr * kLvBN + cq, B + (size_t)(k0 + kr) * n + cq, true);
    }
  };
#pragma unroll
  for (int st = 0; st < kLvStages - 1; ++st) {
    if (st < nk) load(st, st);
    cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<kLvStages - 2>();
    __syncthreads();  // chunk kc has landed; the stage refilled next was consumed
    if (kc + kLvStages - 1 < nk) load((kc + kLvStages - 1) % kLvStages, kc + kLvStages - 1);
    cp_async_commit();
    if (kLowerA && kc * kLvBK > warp_last) continue;  // this warp's A is zero here
    const float* as = As + (kc % kLvStages) * kLvAStage;
    const float* bs = Bs + (kc % kLvStages) * kLvBStage;
#pragma unroll
    for (int k4 = 0; k4 < kLvBK; k4 += 4) {
      float4 a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        a[i] = *reinterpret_cast<const float4*>(as + level_row(tid, i) * kLvAPitch + k4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 b0 = *reinterpret_cast<const float4*>(bs + (k4 + q) * kLvBN + 4 * tx);
        const float4 b1 = *reinterpret_cast<const float4*>(bs + (k4 + q) * kLvBN + 32 + 4 * tx);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float av = kNeg ? -lane_of(a[i], q) : lane_of(a[i], q);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, bv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// Stores level_product's tile at C (leading dimension n), rows < rows.
__device__ __forceinline__ void level_store(float* C, int n, int rows,
                                            const float (&acc)[8][8]) {
  const int tid = threadIdx.x, tx = tid % 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = level_row(tid, i);
    if (r < rows) {
      float* row = C + (size_t)r * n;
      *reinterpret_cast<float4*>(row + 4 * tx) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 32 + 4 * tx) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
  }
}

// One doubling level w (a multiple of 128, w < n): inverted w-blocks at
// a = 2 p w and a + w (the second m2 = min(w, n - a - w) rows wide) become
// one. grid: batch * npairs * (w / 64) * C CTAs in clusters of C, one
// cluster per (strip, pair, matrix), the strips of smaller first column
// (more phase-A work) first.
__global__ void __launch_bounds__(kLvThreads) tri_inv_level_kernel(
    const float* __restrict__ L,  // (batch, n, n)
    float* X,                     // (batch, n, n): read and written
    int n, int w, int npairs, int batch) {
  __shared__ __align__(16) float sm[kLvStages * (kLvAStage + kLvBStage)];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  int idx = blockIdx.x / C;
  const int b = idx % batch;
  idx /= batch;
  const int p = idx % npairs, strip = idx / npairs;
  const int a = 2 * p * w, o2 = a + w, m2 = min(w, n - o2);
  const int c0 = a + strip * kLvBN;  // the strip: columns c0 .. c0 + 63 of block 1
  const float* Lb = L + (size_t)b * n * n;
  float* Xb = X + (size_t)b * n * n;
  const int ntile = (m2 + kLvBM - 1) / kLvBM;

  // X12 = 0 on the strip's rows
  const int q4 = m2 / 4;
  for (int q = rank * kLvThreads + threadIdx.x; q < kLvBN * q4; q += C * kLvThreads) {
    *reinterpret_cast<float4*>(Xb + (size_t)(c0 + q / q4) * n + o2 + (q % q4) * 4) =
        make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }

  float acc[8][8];
  // phase A: T = L21 X11 on the strip (X11[k][c] = 0 for k < c, so k from c0)
  for (int t = rank; t < ntile; t += C) {
    const int r0 = t * kLvBM, rows = min(kLvBM, m2 - r0);
    level_product<false, false>(Lb + (size_t)(o2 + r0) * n + c0,
                                Xb + (size_t)c0 * n + c0, n, o2 - c0, rows, 0, sm, acc);
    level_store(Xb + (size_t)(o2 + r0) * n + c0, n, rows, acc);
  }
  __threadfence();
  cluster.sync();

  // phase B: X21 = -X22 T, in waves of C tiles from the bottom; a tile reads
  // T's rows up to its own last row (X22[r][k] = 0 for k > r), so the rows a
  // wave overwrites are read by no later wave
  for (int top = ntile - 1; top >= 0; top -= C) {
    const int t = top - rank;
    const int r0 = t * kLvBM, rows = min(kLvBM, m2 - r0);
    if (t >= 0) {
      level_product<true, true>(Xb + (size_t)(o2 + r0) * n + o2, Xb + (size_t)o2 * n + c0,
                                n, min(r0 + kLvBM, m2), rows, r0, sm, acc);
    }
    __threadfence();
    cluster.sync();  // every CTA of the wave has read its T
    if (t >= 0) level_store(Xb + (size_t)(o2 + r0) * n + c0, n, rows, acc);
  }
}

}  // namespace medgp
