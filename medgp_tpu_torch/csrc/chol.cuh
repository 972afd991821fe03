// K3 (chol_solve) and K5 (tri_inv) for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel medgp_tpu/ops/pallas_chol.py:
// _chol_solve_kernel (+ _diag_block_factor, _combine_inverse; pallas_call at
// pallas_chol.py:337). Per matrix:
//   L     = chol(K + diag(noise)),
//   alpha = (K + diag(noise))^{-1} y   (forward + backward substitution),
//   linvd = inverses of L's 32x32 diagonal blocks (consumed by K5 and K4).
// K5 replaces pallas_chol.py:_tri_inv_kernel (pallas_call at :410):
//   X = L^{-1} from L and linvd by block forward substitution.
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

__global__ void tri_inv_kernel(
    const float* __restrict__ L,      // (batch, n, n)
    const float* __restrict__ linvd,  // (batch, n/32, 32, 32)
    float* __restrict__ X,            // (batch, n, n) out: L^{-1}
    int n) {
  __shared__ float Ta[kBS][kBS + 1];
  __shared__ float Tb[kBS][kBS + 1];

  const int b = blockIdx.x;
  const int jb = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBS + tx;
  const int NB = n / kBS;
  const int oj = jb * kBS;
  const float* Lb = L + (size_t)b * n * n;
  const float* Db = linvd + (size_t)b * NB * kBS * kBS;
  float* Xb = X + (size_t)b * n * n;

  // rows above the diagonal block are zero; X_jj = inv(L_jj)
  for (int idx = tid; idx < oj * kBS; idx += kCholThreads) {
    Xb[(size_t)(idx / kBS) * n + oj + idx % kBS] = 0.0f;
  }
  for (int m = 0; m < kRowsPerThread; ++m) {
    const int r = ty + m * kRowsPerPass;
    Xb[(size_t)(oj + r) * n + oj + tx] =
        Db[(size_t)jb * kBS * kBS + r * kBS + tx];
  }
  __syncthreads();

  // X_ij = -inv(L_ii) sum_{k=j}^{i-1} L_ik X_kj
  for (int ib = jb + 1; ib < NB; ++ib) {
    const int oi = ib * kBS;
    float acc[kRowsPerThread];
    for (int m = 0; m < kRowsPerThread; ++m) acc[m] = 0.0f;
    for (int kb = jb; kb < ib; ++kb) {
      const int ok = kb * kBS;
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Ta[r][tx] = Lb[(size_t)(oi + r) * n + ok + tx];
        Tb[r][tx] = Xb[(size_t)(ok + r) * n + oj + tx];
      }
      __syncthreads();
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        float s = 0.0f;
        for (int q = 0; q < kBS; ++q) s += Ta[r][q] * Tb[q][tx];
        acc[m] += s;
      }
      __syncthreads();
    }
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int r = ty + m * kRowsPerPass;
      Ta[r][tx] = acc[m];
      Tb[r][tx] = Db[(size_t)ib * kBS * kBS + r * kBS + tx];
    }
    __syncthreads();
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int r = ty + m * kRowsPerPass;
      float s = 0.0f;
      for (int q = 0; q <= r; ++q) s += Tb[r][q] * Ta[q][tx];
      Xb[(size_t)(oi + r) * n + oj + tx] = -s;
    }
    __syncthreads();
  }
}

}  // namespace medgp
