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

}  // namespace medgp
