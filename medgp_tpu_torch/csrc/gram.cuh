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
//     Q=5, D=24, 45 KB at D=48) sits in dynamic shared memory, sized at
//     launch (up to the card's 227 KB a block), and B_q[meta_i, meta_j] is a
//     gather;
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
constexpr unsigned kGramWarpMask = 0xffffffffu;
constexpr size_t kSmemPerBlock = 232448;  // shared memory a Hopper block may opt into

__global__ void gram_lmcsm_kernel(
    const float* __restrict__ t,     // (batch, n)
    const int* __restrict__ meta,    // (batch, n)
    const float* __restrict__ B,     // (batch, Q, D, D)
    const float* __restrict__ mu,    // (batch, Q)
    const float* __restrict__ v,     // (batch, Q)
    const float* __restrict__ mask,  // (batch, n) or nullptr
    float* __restrict__ K,           // (batch, n, n)
    int n, int Q, int D) {
  extern __shared__ float Bs[];  // (Q, D, D), sized at launch
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
// GFLOP), so neither the bytes nor the FP32 rate leaves much headroom, and
// every instruction spent on finding an entry's output is overhead.
//
// What the design does about it:
//   * one CTA per (matrix, band of 32 rows) walks the band's columns in
//     chunks of kBwdChunk; for each chunk one warp builds a stable counting
//     sort of the chunk's unmasked columns by meta (integer, in column
//     order), so each output e owns a contiguous run of sorted positions;
//   * the band's dK rows for the chunk are staged in shared memory with
//     coalesced reads, scattered into sorted order; cos and sin of
//     2 pi mu_q (t_j - t_min) are computed once per column and component
//     into a table beside them (each column's once per CTA, not once per
//     tile), the rows' once per CTA;
//   * the chunk's runs are split among the 8 warps at run boundaries,
//     balanced by entries; in a warp, lane r is row r of the band and all
//     lanes walk the warp's sorted positions together (the column's table
//     entries are one broadcast read), so each (row, output e) sum is a
//     plain register sum over its run in ascending j, stored when the run
//     ends, with B_q[meta_i, e] loaded once per run; no shuffles, no
//     compares per entry; the TPU's one-hot MXU contractions
//     (pallas_gram.py:290-291) are gone; a band whose rows are all padding
//     writes zero partials and stops;
//   * at the end of the band, thread (q, d, e) adds the rows with meta = d
//     in row order; a Hopper grid has no sequential axis to carry sums
//     across bands, so each band writes its partial dB, dmu, dv to a buffer
//     and gram_bwd_reduce_kernel adds the bands in order: every sum is taken
//     in an order fixed by the inputs, so SCG trajectories repeat run to run;
//   * the group's B_q stack, the row sums and the chunk's tables are in
//     dynamic shared memory sized at launch; the C entry takes as many
//     components per pass over dK as fit in the card's 227 KB (up to
//     kBwdQGroup), so D has no fixed cap.
constexpr int kBwdQGroup = 8;   // most components per pass over dK
constexpr int kBwdChunk = 192;  // columns per staged chunk (3 CTAs per SM at D = 24)
constexpr int kBwdBand = kGramTile;
constexpr int kBwdWarps = kGramThreads / 32;

// Dynamic shared memory of gram_bwd_kernel in floats (ints alias floats):
// B_q stack G*D*D, row sums G*D*33, staged dK 32*(chunk+1), cos and sin
// 2*G*chunk, t, mask, meta and sorted position per column 4*chunk, and D
// counting-sort offsets.
__host__ __device__ inline int gram_bwd_smem_floats(int G, int D) {
  return G * D * D + G * D * (kBwdBand + 1) + kBwdBand * (kBwdChunk + 1) +
         2 * G * kBwdChunk + 4 * kBwdChunk + D;
}

// G components per pass, a template parameter so that each thread holds
// exactly G sums and G of each row constant in registers.
template <int G>
__global__ void __launch_bounds__(kGramThreads, 3) gram_bwd_kernel(
    const float* __restrict__ dK,    // (batch, n, n)
    const float* __restrict__ t,     // (batch, n)
    const int* __restrict__ meta,    // (batch, n)
    const float* __restrict__ B,     // (batch, Q, D, D)
    const float* __restrict__ mu,    // (batch, Q)
    const float* __restrict__ v,     // (batch, Q)
    const float* __restrict__ mask,  // (batch, n) or nullptr
    float* __restrict__ dB_part,     // (batch, nband, Q, D, D)
    float* __restrict__ dmv_part,    // (batch, nband, 2, Q)
    int n, int Q, int D, int q0) {
  static_assert(G >= 1 && G <= kBwdQGroup, "components per pass");
  constexpr int CH = kBwdChunk;
  constexpr int WS = kBwdChunk + 1;  // staged row stride
  extern __shared__ float smem[];
  const int DD = D * D;
  float* Bs = smem;                      // (G, D, D)
  constexpr int TS = kBwdBand + 1;       // row-sum stride
  float* T = Bs + G * DD;                // (G, D, TS): row r's sum for output e
  float* W = T + G * D * TS;             // (32, WS): dK rows, sorted columns
  float* cs = W + kBwdBand * WS;         // (G, CH) cos, sorted columns
  float* sn = cs + G * CH;               // (G, CH) sin
  float* tj = sn + G * CH;               // (CH) t_j - t_min
  float* mkj = tj + CH;                  // (CH) mask_j
  int* key = (int*)(mkj + CH);           // (CH) meta_j, sorted
  int* pos = key + CH;                   // (CH) column -> sorted position, -1 if dropped
  int* offs = pos + CH;                  // (D) counting-sort offsets
  __shared__ float red[kGramThreads];
  __shared__ float ti[kBwdBand], mki[kBwdBand];
  __shared__ int mi[kBwdBand];
  __shared__ float rc[G][kBwdBand], rs[G][kBwdBand];
  __shared__ float eg[G], vg[G];
  __shared__ int nsorted;
  __shared__ int wbeg[kBwdWarps + 1];  // each warp's sorted positions

  const int nband = gridDim.x;
  const int band = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = band * kBwdBand;
  const int tid = threadIdx.y * kGramTile + threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* tb = t + (size_t)b * n;
  const int* mb = meta + (size_t)b * n;
  const float* mkb = mask != nullptr ? mask + (size_t)b * n : nullptr;
  const float* dKb = dK + (size_t)b * n * n;

  for (int k = tid; k < G * DD; k += kGramThreads) {
    Bs[k] = B[((size_t)b * Q + q0) * DD + k];
  }
  for (int k = tid; k < G * D * TS; k += kGramThreads) T[k] = 0.0f;
  float tmin = 3.402823466e38f;
  for (int k = tid; k < n; k += kGramThreads) tmin = fminf(tmin, tb[k]);
  red[tid] = tmin;
  __syncthreads();
  for (int s = kGramThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = fminf(red[tid], red[tid + s]);
    __syncthreads();
  }
  tmin = red[0];
  if (tid < kBwdBand) {
    const int i = row0 + tid;
    const int m = i < n ? mb[i] : -1;
    const bool row_ok = m >= 0 && m < D;  // beyond n, or meta out of range: dropped
    ti[tid] = i < n ? tb[i] - tmin : 0.0f;
    mi[tid] = row_ok ? m : 0;
    mki[tid] = row_ok ? (mkb != nullptr ? mkb[i] : 1.0f) : 0.0f;
  } else if (tid < kBwdBand + G) {
    const int g = tid - kBwdBand;
    const float pv = kRefPi * v[(size_t)b * Q + q0 + g];
    eg[g] = -2.0f * (pv * pv);
    vg[g] = v[(size_t)b * Q + q0 + g];
  }
  __syncthreads();
  if (!__syncthreads_or(tid < kBwdBand && mki[tid] != 0.0f)) {
    // every row of the band is padding: zero partials
    float* dBp = dB_part + (((size_t)b * nband + band) * Q + q0) * DD;
    for (int idx = tid; idx < G * DD; idx += kGramThreads) dBp[idx] = 0.0f;
    if (tid < 2 * G) {
      dmv_part[(((size_t)b * nband + band) * 2 + tid % 2) * Q + q0 + tid / 2] = 0.0f;
    }
    return;
  }
  if (tid < G * kBwdBand) {
    const int g = tid / kBwdBand, r = tid % kBwdBand;
    const float muq = mu[(size_t)b * Q + q0 + g];
    sincosf((2.0f * kRefPi) * muq * ti[r], &rs[g][r], &rc[g][r]);
  }

  float dmu_acc[G], dv_acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    dmu_acc[g] = 0.0f;
    dv_acc[g] = 0.0f;
  }

  for (int j0 = 0; j0 < n; j0 += CH) {
    const int cn = min(CH, n - j0);
    __syncthreads();  // the previous chunk's tables consumed

    // the chunk's meta (-1 where dropped: masked or out of range), t and
    // mask, staged with coalesced reads (t and mask in the cos/sin tables,
    // which are filled only after the sort)
    for (int c = tid; c < cn; c += kGramThreads) {
      const int j = j0 + c;
      const int m = mb[j];
      const float mk = mkb != nullptr ? mkb[j] : 1.0f;
      pos[c] = m >= 0 && m < D && mk != 0.0f ? m : -1;
      cs[c] = tb[j] - tmin;
      sn[c] = mk;
    }
    __syncthreads();
    // stable counting sort of the chunk's kept columns by meta (warp 0)
    if (warp == 0) {
      for (int e = lane; e < D; e += 32) offs[e] = 0;
      __syncwarp();
      for (int c0 = 0; c0 < cn; c0 += 32) {
        const int c = c0 + lane;
        const int k = c < cn ? pos[c] : -1;
        const unsigned same = __match_any_sync(kGramWarpMask, k);
        if (k >= 0 && lane == __ffs(same) - 1) offs[k] += __popc(same);
        __syncwarp();
      }
      if (lane == 0) {
        int total = 0;
        for (int e = 0; e < D; ++e) {
          const int cnt = offs[e];
          offs[e] = total;
          total += cnt;
        }
        nsorted = total;
      }
      __syncwarp();
      for (int c0 = 0; c0 < cn; c0 += 32) {
        const int c = c0 + lane;
        const int k = c < cn ? pos[c] : -1;
        const unsigned same = __match_any_sync(kGramWarpMask, k);
        const int p = k >= 0 ? offs[k] + __popc(same & ((1u << lane) - 1u)) : -1;
        if (k >= 0) {
          key[p] = k;
          tj[p] = cs[c];
          mkj[p] = sn[c];
        }
        if (c < cn) pos[c] = p;
        __syncwarp();
        if (k >= 0 && lane == __ffs(same) - 1) offs[k] += __popc(same);
        __syncwarp();
      }
      // offs[e] is now the end of run e; warp w starts at the first run
      // boundary at or past w / 8 of the entries
      if (lane <= kBwdWarps) {
        const int target = lane * nsorted / kBwdWarps;
        int start = 0, e = 0;
        while (start < target) start = offs[e++];
        wbeg[lane] = lane == kBwdWarps ? nsorted : start;
      }
    }
    __syncthreads();
    const int M = nsorted;

    // the band's dK rows for the chunk, coalesced, into sorted order; the
    // columns' cos and sin per component
    for (int r = threadIdx.y; r < kBwdBand; r += kGramRowsPerPass) {
      const int i = row0 + r;
      if (i >= n) continue;
      const float* src = dKb + (size_t)i * n + j0;
      for (int c = threadIdx.x; c < cn; c += kGramTile) {
        const int p = pos[c];
        if (p >= 0) W[r * WS + p] = src[c];
      }
    }
    for (int idx = tid; idx < G * M; idx += kGramThreads) {
      const int g = idx / M, p = idx - g * M;
      const float muq = mu[(size_t)b * Q + q0 + g];
      sincosf((2.0f * kRefPi) * muq * tj[p], &sn[g * CH + p], &cs[g * CH + p]);
    }
    __syncthreads();

    // lane r of every warp is row r; the warp walks its runs in order
    {
      const int r = lane;
      const float mr = mki[r], tir = ti[r];
      const float* Wr = W + r * WS;
      const float* Bi = Bs + mi[r] * D;
      float crow[G], srow[G], ecoef[G], vcoef[G];  // this row's constants
#pragma unroll
      for (int g = 0; g < G; ++g) {
        crow[g] = rc[g][r];
        srow[g] = rs[g][r];
        ecoef[g] = eg[g];
        vcoef[g] = (-4.0f * kRefPi * kRefPi) * vg[g];
      }
      const int p_end = wbeg[warp + 1];
      int p = wbeg[warp];
      while (p < p_end) {
        const int e = key[p];
        const int run_end = min(offs[e], p_end);
        float acc[G], bc[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          acc[g] = 0.0f;
          bc[g] = Bi[g * DD + e];
        }
        for (; p < run_end; ++p) {
          const float w = Wr[p] * (mr * mkj[p]);
          const float d = tir - tj[p];
          const float rsq = d * d;
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float cj = cs[g * CH + p], sj = sn[g * CH + p];
            const float E = expf(ecoef[g] * rsq);
            const float ccss = crow[g] * cj + srow[g] * sj;
            const float ssin = srow[g] * cj - crow[g] * sj;
            const float kq = ccss * E;
            acc[g] += w * kq;
            const float wc = w * bc[g];
            dmu_acc[g] += wc * ((-2.0f * kRefPi) * d * ssin * E);
            dv_acc[g] += wc * (vcoef[g] * rsq * kq);
          }
        }
#pragma unroll
        for (int g = 0; g < G; ++g) T[(g * D + e) * TS + r] += acc[g];
      }
    }
  }

  // band partial of dB: dB_q[d, e] = sum over the band's rows with meta_i = d
  __syncthreads();
  float* dBp = dB_part + (((size_t)b * nband + band) * Q + q0) * DD;
  for (int idx = tid; idx < G * DD; idx += kGramThreads) {
    const int g = idx / DD, dd = (idx / D) % D, ecol = idx % D;
    float s = 0.0f;
    for (int r = 0; r < kBwdBand; ++r) {
      if (mki[r] != 0.0f && mi[r] == dd) s += T[(g * D + ecol) * TS + r];
    }
    dBp[idx] = s;
  }

  // band partials of dmu, dv: a fixed shuffle tree per warp, then warps in order
  __syncthreads();  // red[] reused
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float a = dmu_acc[g], c = dv_acc[g];
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_xor_sync(kGramWarpMask, a, off);
      c += __shfl_xor_sync(kGramWarpMask, c, off);
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
    for (int w = 0; w < kBwdWarps; ++w) s += red[w * 2 * kBwdQGroup + 2 * g + which];
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
