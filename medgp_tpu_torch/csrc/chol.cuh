// K3 (chol_solve) and K5 (tri_inv) for Hopper (sm_90a).
//
// K3 replaces the Pallas TPU kernel medgp_tpu/ops/pallas_chol.py:
// _chol_solve_kernel (+ _diag_block_factor, _combine_inverse; pallas_call at
// pallas_chol.py:337). Per matrix:
//   L     = chol(K + diag(noise)),
//   alpha = (K + diag(noise))^{-1} y   (forward + backward substitution),
//   linvd = inverses of L's 32x32 diagonal blocks (consumed by K5).
// K5 replaces pallas_chol.py:_tri_inv_kernel (pallas_call at :410):
//   X = L^{-1} from L and linvd by block forward substitution.
//
// What bounds them on this card: latency of a serial dependence chain, not
// bytes or FLOPs. A Cholesky of n = 512 is 45 MFLOP and 1 MB; the column
// steps inside a diagonal block and the block steps along the diagonal are
// sequential, and the test stage runs thousands of such matrices per bucket.
//
// What the design does about it (simple first; wgmma/TMA and several CTAs
// per matrix are later work):
//   * one CTA per matrix (K3) and one CTA per (matrix, column block) (K5), so
//     parallelism comes from the batch, and a batch of thousands of
//     (patient, timestamp) systems fills all 132 SMs;
//   * blocked right-looking Cholesky with 32-wide blocks: the diagonal block
//     is factored in shared memory with its inverse riding along (that
//     inverse is linvd), the panel is A_ik * inv(L_kk)^T, and the trailing
//     update touches only lower-triangle 32x32 tiles; the matrix itself
//     lives in the output buffer L (global memory, L2-resident per CTA);
//   * the noise diagonal is folded in on load, the upper triangle is written
//     as zero on load and never touched again, and the substitutions for
//     alpha ride along in the same kernel;
//   * a non-positive (or NaN) pivot becomes NaN, with no clamping and no
//     early exit, so it reaches L's diagonal and the retry loop
//     (ops/nlml.py) sees it, as with the Pallas kernel.
// n must be a multiple of 32; there is no upper bound on n.
#pragma once

namespace medgp {

constexpr int kBS = 32;                   // block width
constexpr int kRowsPerPass = 8;           // blockDim = (32, 8)
constexpr int kCholThreads = kBS * kRowsPerPass;
constexpr int kRowsPerThread = kBS / kRowsPerPass;

__device__ __forceinline__ float quiet_nan() { return __int_as_float(0x7fffffff); }

__global__ void chol_solve_kernel(
    const float* __restrict__ K,      // (batch, n, n)
    const float* __restrict__ noise,  // (batch, n)
    const float* __restrict__ y,      // (batch, n)
    float* __restrict__ L,            // (batch, n, n) out
    float* __restrict__ alpha,        // (batch, n) out
    float* __restrict__ linvd,        // (batch, n/32, 32, 32) out
    int n) {
  __shared__ float Ta[kBS][kBS + 1];
  __shared__ float Tb[kBS][kBS + 1];
  __shared__ float Tm[kBS][kBS + 1];
  __shared__ float red[kRowsPerPass][kBS + 1];
  __shared__ float zk[kBS];
  __shared__ float tmp[kBS];

  const int b = blockIdx.x;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kBS + tx;
  const int NB = n / kBS;
  const float* Kb = K + (size_t)b * n * n;
  const float* nb = noise + (size_t)b * n;
  const float* yb = y + (size_t)b * n;
  float* Lb = L + (size_t)b * n * n;
  float* ab = alpha + (size_t)b * n;
  float* Db = linvd + (size_t)b * NB * kBS * kBS;

  // load the lower triangle of K + diag(noise); the upper triangle is zero
  const size_t nn = (size_t)n * n;
  for (size_t idx = tid; idx < nn; idx += kCholThreads) {
    const int r = (int)(idx / n);
    const int c = (int)(idx - (size_t)r * n);
    float val = 0.0f;
    if (c < r) val = Kb[idx];
    else if (c == r) val = Kb[idx] + nb[r];
    Lb[idx] = val;
  }
  // alpha holds y, then z = L^{-1} y, then the solution
  for (int k = tid; k < n; k += kCholThreads) ab[k] = yb[k];
  __syncthreads();

  for (int kb = 0; kb < NB; ++kb) {
    const int o = kb * kBS;

    // ---- factor the diagonal block in shared memory ----
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int r = ty + m * kRowsPerPass;
      Tm[r][tx] = tx <= r ? Lb[(size_t)(o + r) * n + o + tx] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kBS; ++j) {
      if (tid == 0) {
        const float d = Tm[j][j];
        Tm[j][j] = d > 0.0f ? sqrtf(d) : quiet_nan();
      }
      __syncthreads();
      if (tid > j && tid < kBS) Tm[tid][j] = Tm[tid][j] / Tm[j][j];
      __syncthreads();
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        if (r > j && tx > j && tx <= r) Tm[r][tx] -= Tm[r][j] * Tm[tx][j];
      }
      __syncthreads();
    }
    // inverse of the diagonal block (lower): thread c solves column c
    if (tid < kBS) {
      const int c = tid;
      for (int r = 0; r < kBS; ++r) {
        if (r < c) {
          Tb[r][c] = 0.0f;
        } else {
          float s = r == c ? 1.0f : 0.0f;
          for (int q = c; q < r; ++q) s -= Tm[r][q] * Tb[q][c];
          Tb[r][c] = s / Tm[r][r];
        }
      }
    }
    __syncthreads();
    for (int m = 0; m < kRowsPerThread; ++m) {
      const int r = ty + m * kRowsPerPass;
      Lb[(size_t)(o + r) * n + o + tx] = Tm[r][tx];
      Db[(size_t)kb * kBS * kBS + r * kBS + tx] = Tb[r][tx];
    }
    // forward substitution: z_k = inv(L_kk) y_k
    if (tid < kBS) {
      float s = 0.0f;
      for (int q = 0; q <= tid; ++q) s += Tb[tid][q] * ab[o + q];
      zk[tid] = s;
    }
    __syncthreads();
    if (tid < kBS) ab[o + tid] = zk[tid];

    // ---- panel: L_ik = A_ik inv(L_kk)^T, and y_i -= L_ik z_k ----
    for (int ib = kb + 1; ib < NB; ++ib) {
      const int oi = ib * kBS;
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Ta[r][tx] = Lb[(size_t)(oi + r) * n + o + tx];
      }
      __syncthreads();
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        float s = 0.0f;
        for (int q = 0; q <= tx; ++q) s += Ta[r][q] * Tb[tx][q];
        Tm[r][tx] = s;
        Lb[(size_t)(oi + r) * n + o + tx] = s;
      }
      __syncthreads();
      if (tid < kBS) {
        float s = 0.0f;
        for (int c = 0; c < kBS; ++c) s += Tm[tid][c] * zk[c];
        ab[oi + tid] -= s;
      }
      __syncthreads();
    }

    // ---- trailing update of the lower triangle: A_ij -= L_ik L_jk^T ----
    for (int ib = kb + 1; ib < NB; ++ib) {
      const int oi = ib * kBS;
      for (int m = 0; m < kRowsPerThread; ++m) {
        const int r = ty + m * kRowsPerPass;
        Ta[r][tx] = Lb[(size_t)(oi + r) * n + o + tx];
      }
      for (int jb = kb + 1; jb <= ib; ++jb) {
        const int oj = jb * kBS;
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int r = ty + m * kRowsPerPass;
          Tb[r][tx] = Lb[(size_t)(oj + r) * n + o + tx];
        }
        __syncthreads();
        for (int m = 0; m < kRowsPerThread; ++m) {
          const int r = ty + m * kRowsPerPass;
          if (ib != jb || tx <= r) {
            float s = 0.0f;
            for (int q = 0; q < kBS; ++q) s += Ta[r][q] * Tb[tx][q];
            Lb[(size_t)(oi + r) * n + oj + tx] -= s;
          }
        }
        __syncthreads();
      }
    }
  }

  // ---- backward substitution: L^T alpha = z ----
  for (int kb = NB - 1; kb >= 0; --kb) {
    const int o = kb * kBS;
    float s = 0.0f;
    for (int r = o + kBS + ty; r < n; r += kRowsPerPass) {
      s += Lb[(size_t)r * n + o + tx] * ab[r];
    }
    red[ty][tx] = s;
    __syncthreads();
    if (tid < kBS) {
      float tot = 0.0f;
      for (int q = 0; q < kRowsPerPass; ++q) tot += red[q][tid];
      zk[tid] = ab[o + tid] - tot;
    }
    __syncthreads();
    if (tid < kBS) {
      const float* M = Db + (size_t)kb * kBS * kBS;
      float a = 0.0f;
      for (int r = tid; r < kBS; ++r) a += M[r * kBS + tid] * zk[r];
      tmp[tid] = a;
    }
    __syncthreads();
    if (tid < kBS) ab[o + tid] = tmp[tid];
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
