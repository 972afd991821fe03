// K1: batched LMC-SM gram for Hopper (sm_90a), one pass, no intermediates.
//
// Replaces the Pallas TPU kernel medgp_tpu/ops/pallas_gram.py:_gram_fwd_kernel
// (launcher _gram_fwd_batched, pallas_call at pallas_gram.py:236):
//
//   K_ij = sum_q B_q[meta_i, meta_j] * cos(2 pi mu_q d_ij) * exp(-2 (pi v_q)^2 d_ij^2)
//
// with d_ij = t_i - t_j, t shifted by min(t) over the row (as the Pallas
// entry does, pallas_gram.py:397) and the reference's PI = 3.14159265.
// Optional fused mask_gram epilogue: padded rows/cols are zeroed and get a
// unit diagonal.
//
// What bounds it on this card: the output. Each matrix is 4 n^2 bytes
// written once, while the inputs are O(n + Q D^2). The arithmetic per output
// entry is Q exponentials plus a few FMAs, so the kernel is write-bound as
// long as no per-entry sin/cos is evaluated.
//
// What the design does about it:
//   * the TPU's one-hot MXU gather and its f32x2 split (pallas_gram.py:12-16,
//     117-140) are dropped: the patient's B_q stack (Q*D*D floats, 11.5 KB at
//     Q=5, D=24) sits in shared memory and B_q[meta_i, meta_j] is a gather;
//   * cos(2 pi mu (t_i - t_j)) = c_i c_j + s_i s_j (rank-2 identity, as the
//     Pallas kernel uses): a 32x32 tile needs 64 sincos per component, not
//     1024 cos, leaving one expf per entry and component;
//   * 32x32 output tiles, 256 threads, four rows per thread; stores are
//     row-contiguous across a warp. Any n works (the ragged edge is masked).
#pragma once

namespace medgp {

constexpr float kRefPi = 3.14159265f;  // medgp_tpu/models/params.py:REF_PI
constexpr int kGramTile = 32;
constexpr int kGramRowsPerPass = 8;    // blockDim = (32, 8)
constexpr int kGramThreads = kGramTile * kGramRowsPerPass;
constexpr int kMaxBStack = 8192;       // Q*D*D floats held in shared memory

__global__ void gram_lmcsm_kernel(
    const float* __restrict__ t,     // (batch, n)
    const int* __restrict__ meta,    // (batch, n)
    const float* __restrict__ B,     // (batch, Q, D, D)
    const float* __restrict__ mu,    // (batch, Q)
    const float* __restrict__ v,     // (batch, Q)
    const float* __restrict__ mask,  // (batch, n) or nullptr
    float* __restrict__ K,           // (batch, n, n)
    int n, int Q, int D) {
  __shared__ float Bs[kMaxBStack];
  __shared__ float red[kGramThreads];
  __shared__ float ti[kGramTile], tj[kGramTile];
  __shared__ int mi[kGramTile], mj[kGramTile];
  __shared__ float ci[kGramTile], si[kGramTile], cj[kGramTile], sj[kGramTile];

  const int ntile = (n + kGramTile - 1) / kGramTile;
  const long long tiles = (long long)ntile * ntile;
  const int b = (int)(blockIdx.x / tiles);
  const int tile = (int)(blockIdx.x % tiles);
  const int row0 = (tile / ntile) * kGramTile;
  const int col0 = (tile % ntile) * kGramTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kGramTile + tx;

  const float* tb = t + (size_t)b * n;
  const int* mb = meta + (size_t)b * n;
  const int bstack = Q * D * D;
  for (int k = tid; k < bstack; k += kGramThreads) {
    Bs[k] = B[(size_t)b * bstack + k];
  }

  // min(t) over the whole row, padding included (pallas_gram.py:397)
  float tmin = 3.402823466e38f;
  for (int k = tid; k < n; k += kGramThreads) tmin = fminf(tmin, tb[k]);
  red[tid] = tmin;
  __syncthreads();
  for (int s = kGramThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fminf(red[tid], red[tid + s]);
    __syncthreads();
  }
  tmin = red[0];

  if (tid < kGramTile) {
    const int i = row0 + tid;
    ti[tid] = i < n ? tb[i] - tmin : 0.0f;
    mi[tid] = i < n ? mb[i] : 0;
  } else if (tid < 2 * kGramTile) {
    const int j = col0 + tid - kGramTile;
    tj[tid - kGramTile] = j < n ? tb[j] - tmin : 0.0f;
    mj[tid - kGramTile] = j < n ? mb[j] : 0;
  }

  float acc[kGramTile / kGramRowsPerPass];
#pragma unroll
  for (int m = 0; m < kGramTile / kGramRowsPerPass; ++m) acc[m] = 0.0f;

  for (int q = 0; q < Q; ++q) {
    const float muq = mu[(size_t)b * Q + q];
    const float pv = kRefPi * v[(size_t)b * Q + q];
    const float e = -2.0f * (pv * pv);
    __syncthreads();  // tiles loaded / previous component's sincos consumed
    if (tid < kGramTile) {
      sincosf((2.0f * kRefPi) * muq * ti[tid], &si[tid], &ci[tid]);
    } else if (tid < 2 * kGramTile) {
      const int k = tid - kGramTile;
      sincosf((2.0f * kRefPi) * muq * tj[k], &sj[k], &cj[k]);
    }
    __syncthreads();
    const float* Bq = Bs + q * D * D;
#pragma unroll
    for (int m = 0; m < kGramTile / kGramRowsPerPass; ++m) {
      const int r = ty + m * kGramRowsPerPass;
      const float d = ti[r] - tj[tx];
      const float coef = Bq[mi[r] * D + mj[tx]];
      const float cc = ci[r] * cj[tx] + si[r] * sj[tx];
      acc[m] += coef * (cc * expf(e * (d * d)));
    }
  }

  float* Kb = K + (size_t)b * n * n;
  const int j = col0 + tx;
#pragma unroll
  for (int m = 0; m < kGramTile / kGramRowsPerPass; ++m) {
    const int i = row0 + ty + m * kGramRowsPerPass;
    if (i < n && j < n) {
      float val = acc[m];
      if (mask != nullptr) {
        const float mk_i = mask[(size_t)b * n + i];
        const float mk_j = mask[(size_t)b * n + j];
        val = val * (mk_i * mk_j) + (i == j ? 1.0f - mk_i : 0.0f);
      }
      Kb[(size_t)i * n + j] = val;
    }
  }
}

// K2: the gram's VJP for Hopper (sm_90a), deterministic, no atomics.
//
// Replaces the Pallas TPU kernel medgp_tpu/ops/pallas_gram.py:
// _gram_bwd_kernel (launcher _gram_bwd_batched, pallas_call at
// pallas_gram.py:339). With w = dK, or dK * (m m^T) for the masked gram
// (the fused epilogue's diagonal fill does not depend on the hypers):
//
//   dB_q[d, e] = sum_{meta_i = d, meta_j = e} w_ij k_q,ij
//   dmu_q      = sum_ij w_ij B_q[meta_i, meta_j] (-2 pi d_ij sin(2 pi mu_q d_ij) E_q,ij)
//   dv_q       = sum_ij w_ij B_q[meta_i, meta_j] (-4 pi^2 v_q d_ij^2 k_q,ij)
//
// with E_q = exp(-2 (pi v_q)^2 d^2) and k_q = cos(2 pi mu_q d) E_q. dK is
// not assumed symmetric. t is shifted by min(t) over the whole row, padding
// included, as in K1 and the JAX backward (pallas_gram.py:412).
//
// What bounds it on this card: reading dK (4 n^2 bytes per matrix) against
// about twenty operations per entry and component, one of them an exp; at
// Q = 5 the two are of the same order (B = 128, n = 512: 134 MB and ~3.4
// GFLOP), so neither the bytes nor the FP32 rate leaves much headroom.
//
// What the design does about it:
//   * the TPU's one-hot MXU contractions for dB (pallas_gram.py:290-291) are
//     replaced by a gather-free segmented sum: a 32x32 tile of w * k_q is
//     staged in shared memory, and thread (row i, output e) adds the tile's
//     entries whose column has meta = e, in a fixed order; at the end of the
//     band, thread (d, e) adds the rows whose meta = d. D <= kBwdMaxD;
//   * one CTA per (matrix, band of 32 rows) walks every column tile of its
//     band, so dK is read once per group of up to kBwdQGroup components
//     (one group at Q <= 8); the per-row sincos of each component is
//     computed once per band and the per-column one once per tile (the
//     rank-2 identities of K1: cos and sin of 2 pi mu (t_i - t_j));
//   * a Hopper grid has no sequential axis to carry sums across tiles, so
//     every band writes its partial dB, dmu, dv to a buffer, and a second
//     kernel (gram_bwd_reduce_kernel) adds the bands in order: the result
//     does not depend on scheduling, so SCG trajectories repeat run to run.
constexpr int kBwdQGroup = 8;  // components per pass over dK
constexpr int kBwdMaxD = 32;   // outputs per patient the segmented sum takes
constexpr int kBwdItems = kGramTile * kBwdMaxD / kGramThreads;  // (i, e) per thread

// Dynamic shared memory of gram_bwd_kernel, in floats: the group's B_q
// stack, then the (w * k_q) tiles, reused for the per-row sums at the end.
__host__ __device__ inline int gram_bwd_smem_floats(int G, int D) {
  return G * D * D + G * kGramTile * (kGramTile + 1);
}

__global__ void gram_bwd_kernel(
    const float* __restrict__ dK,    // (batch, n, n)
    const float* __restrict__ t,     // (batch, n)
    const int* __restrict__ meta,    // (batch, n)
    const float* __restrict__ B,     // (batch, Q, D, D)
    const float* __restrict__ mu,    // (batch, Q)
    const float* __restrict__ v,     // (batch, Q)
    const float* __restrict__ mask,  // (batch, n) or nullptr
    float* __restrict__ dB_part,     // (batch, nband, Q, D, D)
    float* __restrict__ dmv_part,    // (batch, nband, 2, Q)
    int n, int Q, int D, int q0, int G) {
  extern __shared__ float smem[];
  float* Bs = smem;                  // (G, D, D)
  float* WK = smem + G * D * D;      // (G, 32, 33): w * k_q, then row sums
  __shared__ float red[kGramThreads];
  __shared__ float Wt[kGramTile][kGramTile + 1];
  __shared__ float ti[kGramTile], tj[kGramTile], mki[kGramTile], mkj[kGramTile];
  __shared__ int mi[kGramTile], mj[kGramTile];
  __shared__ float ci[kBwdQGroup][kGramTile], si[kBwdQGroup][kGramTile];
  __shared__ float cj[kBwdQGroup][kGramTile], sj[kBwdQGroup][kGramTile];

  const int nband = gridDim.x;
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = band * kGramTile;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kGramTile + tx;
  const float* tb = t + (size_t)b * n;
  const int* mb = meta + (size_t)b * n;
  const float* dKb = dK + (size_t)b * n * n;
  const int DD = D * D;

  for (int k = tid; k < G * DD; k += kGramThreads) {
    Bs[k] = B[((size_t)b * Q + q0) * DD + k];
  }
  float tmin = 3.402823466e38f;
  for (int k = tid; k < n; k += kGramThreads) tmin = fminf(tmin, tb[k]);
  red[tid] = tmin;
  __syncthreads();
  for (int s = kGramThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fminf(red[tid], red[tid + s]);
    __syncthreads();
  }
  tmin = red[0];
  if (tid < kGramTile) {
    const int i = row0 + tid;
    ti[tid] = i < n ? tb[i] - tmin : 0.0f;
    mi[tid] = i < n ? mb[i] : 0;
    mki[tid] = i < n ? (mask != nullptr ? mask[(size_t)b * n + i] : 1.0f) : 0.0f;
  }
  __syncthreads();
  if (tid < G * kGramTile) {
    const int g = tid / kGramTile, r = tid % kGramTile;
    const float muq = mu[(size_t)b * Q + q0 + g];
    sincosf((2.0f * kRefPi) * muq * ti[r], &si[g][r], &ci[g][r]);
  }

  float T[kBwdItems][kBwdQGroup];
  float dmu_acc[kBwdQGroup], dv_acc[kBwdQGroup];
#pragma unroll
  for (int g = 0; g < kBwdQGroup; ++g) {
    dmu_acc[g] = 0.0f;
    dv_acc[g] = 0.0f;
#pragma unroll
    for (int m = 0; m < kBwdItems; ++m) T[m][g] = 0.0f;
  }
  const int items = kGramTile * D;

  for (int jt = 0; jt < nband; ++jt) {
    const int col0 = jt * kGramTile;
    __syncthreads();  // the previous tile's WK, Wt and column data consumed
    if (tid < kGramTile) {
      const int j = col0 + tid;
      tj[tid] = j < n ? tb[j] - tmin : 0.0f;
      mj[tid] = j < n ? mb[j] : 0;
      mkj[tid] = j < n ? (mask != nullptr ? mask[(size_t)b * n + j] : 1.0f) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m < kGramTile / kGramRowsPerPass; ++m) {
      const int r = ty + m * kGramRowsPerPass;
      const int i = row0 + r, j = col0 + tx;
      Wt[r][tx] = i < n && j < n ? dKb[(size_t)i * n + j] : 0.0f;
    }
    __syncthreads();
    if (tid < G * kGramTile) {
      const int g = tid / kGramTile, c = tid % kGramTile;
      const float muq = mu[(size_t)b * Q + q0 + g];
      sincosf((2.0f * kRefPi) * muq * tj[c], &sj[g][c], &cj[g][c]);
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kBwdQGroup; ++g) {
      if (g < G) {
        const float vq = v[(size_t)b * Q + q0 + g];
        const float pv = kRefPi * vq;
        const float e = -2.0f * (pv * pv);
        const float* Bq = Bs + g * DD;
        float* WKg = WK + g * kGramTile * (kGramTile + 1);
#pragma unroll
        for (int m = 0; m < kGramTile / kGramRowsPerPass; ++m) {
          const int r = ty + m * kGramRowsPerPass;
          const float w = Wt[r][tx] * (mki[r] * mkj[tx]);
          const float d = ti[r] - tj[tx];
          const float rsq = d * d;
          const float E = expf(e * rsq);
          const float ccss = ci[g][r] * cj[g][tx] + si[g][r] * sj[g][tx];
          const float ssin = si[g][r] * cj[g][tx] - ci[g][r] * sj[g][tx];
          const float kq = ccss * E;
          WKg[r * (kGramTile + 1) + tx] = w * kq;
          const float wc = w * Bq[mi[r] * D + mj[tx]];
          dmu_acc[g] += wc * ((-2.0f * kRefPi) * d * ssin * E);
          dv_acc[g] += wc * ((-4.0f * kRefPi * kRefPi) * vq * rsq * kq);
        }
      }
    }
    __syncthreads();
    // T[(i, e)] += sum over this tile's columns with meta_j = e, in order
#pragma unroll
    for (int m = 0; m < kBwdItems; ++m) {
      const int item = tid + m * kGramThreads;
      if (item < items) {
        const int r = item / D, ecol = item % D;
        for (int c = 0; c < kGramTile; ++c) {
          if (mj[c] == ecol) {
#pragma unroll
            for (int g = 0; g < kBwdQGroup; ++g) {
              if (g < G) T[m][g] += WK[(g * kGramTile + r) * (kGramTile + 1) + c];
            }
          }
        }
      }
    }
  }

  // band partial of dB: dB_q[d, e] = sum over the band's rows with meta_i = d
  __syncthreads();
#pragma unroll
  for (int m = 0; m < kBwdItems; ++m) {
    const int item = tid + m * kGramThreads;
    if (item < items) {
      const int r = item / D, ecol = item % D;
#pragma unroll
      for (int g = 0; g < kBwdQGroup; ++g) {
        if (g < G) WK[(g * kGramTile + r) * (kGramTile + 1) + ecol] = T[m][g];
      }
    }
  }
  __syncthreads();
  float* dBp = dB_part + (((size_t)b * nband + band) * Q + q0) * DD;
  for (int idx = tid; idx < G * DD; idx += kGramThreads) {
    const int g = idx / DD, dd = (idx / D) % D, ecol = idx % D;
    float s = 0.0f;
    for (int r = 0; r < kGramTile; ++r) {
      if (mi[r] == dd) s += WK[(g * kGramTile + r) * (kGramTile + 1) + ecol];
    }
    dBp[idx] = s;
  }

  // band partials of dmu, dv: a fixed shuffle tree per warp, then warps in order
  const int lane = tid & 31, warp = tid >> 5;
  __syncthreads();  // red[] reused
#pragma unroll
  for (int g = 0; g < kBwdQGroup; ++g) {
    float a = dmu_acc[g], c = dv_acc[g];
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(0xffffffffu, a, off);
      c += __shfl_xor_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      red[warp * 2 * kBwdQGroup + 2 * g] = a;
      red[warp * 2 * kBwdQGroup + 2 * g + 1] = c;
    }
  }
  __syncthreads();
  if (tid < 2 * G) {
    const int g = tid / 2, which = tid % 2;
    float s = 0.0f;
    for (int w = 0; w < kGramThreads / 32; ++w) s += red[w * 2 * kBwdQGroup + 2 * g + which];
    dmv_part[(((size_t)b * nband + band) * 2 + which) * Q + q0 + g] = s;
  }
}

// Second pass of K2: add the bands' partials in order.
// dB (batch, Q, D, D), dmu and dv (batch, Q).
__global__ void gram_bwd_reduce_kernel(
    const float* __restrict__ dB_part, const float* __restrict__ dmv_part,
    float* __restrict__ dB, float* __restrict__ dmu, float* __restrict__ dv,
    int nband, int Q, int D) {
  const int b = blockIdx.y;
  const int per = Q * D * D;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx < per) {
    float s = 0.0f;
    for (int k = 0; k < nband; ++k) s += dB_part[((size_t)b * nband + k) * per + idx];
    dB[(size_t)b * per + idx] = s;
  } else if (idx < per + 2 * Q) {
    const int which = (idx - per) / Q, q = (idx - per) % Q;
    float s = 0.0f;
    for (int k = 0; k < nband; ++k) s += dmv_part[(((size_t)b * nband + k) * 2 + which) * Q + q];
    (which == 0 ? dmu : dv)[(size_t)b * Q + q] = s;
  }
}

}  // namespace medgp
