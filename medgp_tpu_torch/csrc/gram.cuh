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
// written once, while the inputs are O(n + Q D^2): at B = 32, n = 512 that
// is 33.5 MB, 0.010 ms at 3.35 TB/s. Beside it, the exponentials: one
// expf per distinct entry and component, B Q n (n + 1) / 2 of them, on
// the SFU's 16 results per SM and clock (0.005 ms at the same shape).
// The FMAs around them are under a third of either.
//
// What the design does about it:
//   * K is symmetric: only the lower-triangle 64x64 tile pairs (I >= J)
//     are computed; an off-diagonal tile is stored in its own place and,
//     through a padded staging buffer in shared memory (64 x 65 floats),
//     transposed into (J, I); a diagonal tile goes out of the staging
//     buffer with its upper half taken from its lower half. The expf
//     calls and coefficient gathers are halved, the bytes written are not,
//     and K equals its transpose bitwise whether or not B_q is;
//   * a CTA walks a contiguous run of one matrix's tile pairs (row-major
//     over the lower triangle); the launch plan, run length and CTA count,
//     is medgp_tpu_torch/ops/cuda_gram.py:gram_plan. The run's prologue is
//     paid once: the patient's B_q stack (Q*D*D floats, 11.5 KB at Q=5,
//     D=24) into shared memory, mu_q and the exponent's coefficient per
//     component, and min(t) by warp shuffles with a single barrier;
//   * per tile pair, the cos and sin of 2 pi mu_q t of its 64 rows and 64
//     columns (rank-2 identity, as the Pallas kernel uses:
//     cos(2 pi mu (t_i - t_j)) = c_i c_j + s_i s_j), with their t, meta
//     and mask, go into shared memory in one pass by all 256 threads
//     (Q / 2 sincosf a thread against 16 Q expf), from t, meta and mask
//     that each thread loaded into registers during the previous tile
//     pair. They are built per tile pair and not once per run: a run's
//     columns span the whole matrix, and tables of every point (8 Q n
//     bytes) would not fit beside a D = 64 stack at n = 2048. Two barriers
//     per tile pair: tables built, then the staging buffer filled; none
//     inside the inner loop;
//   * each thread holds a 4x4 micro-tile, rows ty + 16 m, four consecutive
//     columns, and stores each row as one 16-byte float4 (a warp writes two
//     256-byte rows); the mirrored tile leaves the staging buffer the same
//     way (a TMA bulk store was not tried: a 64-column tile row is one
//     256-byte run either way). n not a multiple of 4 takes scalar stores
//     (rows are then not 16-byte aligned); the ragged edge is masked;
//   * each lower entry's arithmetic is the earlier one-tile-per-CTA K1's: the same
//     per-point sincosf, d = t_i - t_j, cc = c_i c_j + s_i s_j and
//     acc += coef * (cc * expf(e d^2)) over q in ascending order, so the
//     lower triangle, the half K3 reads, keeps its bits.
#pragma once

namespace medgp {

constexpr float kRefPi = 3.14159265f;  // medgp_tpu/models/params.py:REF_PI
constexpr unsigned kGramWarpMask = 0xffffffffu;
constexpr size_t kSmemPerBlock = 232448;  // shared memory a Hopper block may opt into

constexpr int kFwdTile = 64;               // tile pair edge
constexpr int kFwdThreads = 256;           // 16 x 16 threads, 4x4 entries each
constexpr int kFwdStage = kFwdTile + 1;    // staging row stride (padded)
constexpr int kFwdCtasPerSm = 3;           // register budget: 85 a thread

// Dynamic shared memory of gram_lmcsm_kernel in floats (ints alias floats):
// cos and sin of the tile's columns and rows 4*Q*64, their t, mask and meta
// 6*64, the staging buffer 64*65, mu and exponent coefficients 2*Q, eight
// warp minima, and the B_q stack Q*D*D (last, so that the tables above
// stay 16-byte aligned for float4 reads).
__host__ __device__ inline int gram_fwd_smem_floats(int Q, int D) {
  return 4 * Q * kFwdTile + 6 * kFwdTile + kFwdTile * kFwdStage + 2 * Q + 8 + Q * D * D;
}

__global__ void __launch_bounds__(kFwdThreads, kFwdCtasPerSm) gram_lmcsm_kernel(
    const float* __restrict__ t,     // (batch, n)
    const int* __restrict__ meta,    // (batch, n)
    const float* __restrict__ B,     // (batch, Q, D, D)
    const float* __restrict__ mu,    // (batch, Q)
    const float* __restrict__ v,     // (batch, Q)
    const float* __restrict__ mask,  // (batch, n) or nullptr
    float* __restrict__ K,           // (batch, n, n)
    int n, int Q, int D, int items_per_cta, int runs) {
  constexpr int T = kFwdTile, ST = kFwdStage;
  extern __shared__ __align__(16) float smem[];
  const int TQ = Q * T;
  float* cJ = smem;            // (Q, 64) cos 2 pi mu_q t of the tile's columns
  float* sJ = cJ + TQ;         // (Q, 64) sin
  float* cI = sJ + TQ;         // (Q, 64) the rows'
  float* sI = cI + TQ;
  float* tI = sI + TQ;         // (64) t - min(t), rows
  float* tJ = tI + T;          // columns
  float* kI = tJ + T;          // mask, rows
  float* kJ = kI + T;
  int* mI = (int*)(kJ + T);    // meta, rows
  int* mJ = mI + T;
  float* S = (float*)(mJ + T); // (64, 65) staging
  float* mus = S + T * ST;     // (Q) mu_q
  float* es = mus + Q;         // (Q) -2 (pi v_q)^2
  float* red = es + Q;         // (8) warp minima
  float* Bs = red + 8;         // (Q, D, D)

  const int b = blockIdx.x / runs;
  const int nt = (n + T - 1) / T;
  const int pairs = nt * (nt + 1) / 2;
  const int k0 = (blockIdx.x - b * runs) * items_per_cta;
  const int k1 = min(k0 + items_per_cta, pairs);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;
  const int DD = D * D;
  const float* tb = t + (size_t)b * n;
  const int* mb = meta + (size_t)b * n;
  const float* mkb = mask != nullptr ? mask + (size_t)b * n : nullptr;
  float* Kb = K + (size_t)b * n * n;
  const bool vec = (n & 3) == 0;  // rows 16-byte aligned: float4 stores

  // the run's prologue: B_q stack, per-component constants, min(t) over the
  // whole row, padding included (pallas_gram.py:397)
#pragma unroll 8
  for (int k = tid; k < Q * DD; k += kFwdThreads) Bs[k] = B[(size_t)b * Q * DD + k];
  if (tid < Q) {
    const float pv = kRefPi * v[(size_t)b * Q + tid];
    mus[tid] = mu[(size_t)b * Q + tid];
    es[tid] = -2.0f * (pv * pv);
  }
  float tmin = 3.402823466e38f;
  for (int k = tid; k < n; k += kFwdThreads) tmin = fminf(tmin, tb[k]);
  for (int off = 16; off > 0; off >>= 1) {
    tmin = fminf(tmin, __shfl_xor_sync(kGramWarpMask, tmin, off));
  }
  if (lane == 0) red[warp] = tmin;
  __syncthreads();
  tmin = red[0];
#pragma unroll
  for (int w = 1; w < kFwdThreads / 32; ++w) tmin = fminf(tmin, red[w]);

  // first tile pair of the run: item k is (I, J) with k = I (I + 1) / 2 + J
  int I = (int)((sqrtf(8.0f * (float)k0 + 1.0f) - 1.0f) * 0.5f);
  while (I > 0 && I * (I + 1) / 2 > k0) --I;
  while ((I + 1) * (I + 2) / 2 <= k0) ++I;
  int J = k0 - I * (I + 1) / 2;

  // thread tid serves point p = tid % 128 of a tile pair (a row for p < 64,
  // else a column) and components q = tid / 128, + 2, ...: it holds the
  // point's t, meta and mask in registers, loaded one tile pair ahead
  // (predicated loads, nothing waits on them before the next tile pair;
  // t beyond n reads as min(t), so that t - min(t) is 0 there)
  const int p = tid % (2 * T), loc = p % T;
  const bool pcol = p >= T;
  float pt, pk;
  int pm;
  auto load_point = [&](int row0, int col0) {
    const int g = (pcol ? col0 : row0) + loc;
    pt = tmin;
    pm = 0;
    pk = 0.0f;
    if (g < n) {
      pt = tb[g];
      pm = mb[g];
      if (mkb != nullptr) pk = mkb[g];
    }
  };
  load_point(I * T, J * T);

  for (int k = k0; k < k1; ++k) {
    const int row0 = I * T, col0 = J * T;
    const bool diag = I == J;
    // tables of the tile pair's 64 rows and 64 columns
    const float tv = pt - tmin;
    for (int q = tid / (2 * T); q < Q; q += kFwdThreads / (2 * T)) {
      float s, c;
      sincosf((2.0f * kRefPi) * mus[q] * tv, &s, &c);
      (pcol ? cJ : cI)[q * T + loc] = c;
      (pcol ? sJ : sI)[q * T + loc] = s;
    }
    if (tid < 2 * T) {
      (pcol ? tJ : tI)[loc] = tv;
      (pcol ? mJ : mI)[loc] = pm;
      (pcol ? kJ : kI)[loc] = pk;
    }
    __syncthreads();  // tables built; the previous tile's staging read
    if (++J > I) {    // the next tile pair, its points loaded during this one
      ++I;
      J = 0;
    }
    if (k + 1 < k1) load_point(I * T, J * T);

    float acc[4][4], rsq[4][4];
    int mrow[4], mcol[4];
    const float4 tj4 = *reinterpret_cast<const float4*>(tJ + 4 * tx);
    const float tj[4] = {tj4.x, tj4.y, tj4.z, tj4.w};
#pragma unroll
    for (int c = 0; c < 4; ++c) mcol[c] = mJ[4 * tx + c];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = ty + 16 * m;
      mrow[m] = mI[r] * D;
      const float ti = tI[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float d = ti - tj[c];
        rsq[m][c] = d * d;
        acc[m][c] = 0.0f;
      }
    }
    for (int q = 0; q < Q; ++q) {
      const float e = es[q];
      const float* Bq = Bs + q * DD;
      const float4 cj4 = *reinterpret_cast<const float4*>(cJ + q * T + 4 * tx);
      const float4 sj4 = *reinterpret_cast<const float4*>(sJ + q * T + 4 * tx);
      const float cj[4] = {cj4.x, cj4.y, cj4.z, cj4.w};
      const float sj[4] = {sj4.x, sj4.y, sj4.z, sj4.w};
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const int r = ty + 16 * m;
        const float ci = cI[q * T + r], si = sI[q * T + r];
        const float* Brow = Bq + mrow[m];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float coef = Brow[mcol[c]];
          const float cc = ci * cj[c] + si * sj[c];
          acc[m][c] += coef * (cc * expf(e * rsq[m][c]));
        }
      }
    }

    // mask_gram epilogue, then the tile's own place (off-diagonal) and the
    // staging buffer
    const int j0 = col0 + 4 * tx;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = ty + 16 * m, i = row0 + r;
      if (mkb != nullptr) {
        const float mk_i = kI[r];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float mk_j = kJ[4 * tx + c];
          acc[m][c] = acc[m][c] * (mk_i * mk_j) + (i == j0 + c ? 1.0f - mk_i : 0.0f);
        }
      }
      if (!diag && i < n) {
        float* dst = Kb + (size_t)i * n + j0;
        if (vec && j0 < n) {
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (j0 + c < n) dst[c] = acc[m][c];
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) S[r * ST + 4 * tx + c] = acc[m][c];
    }
    __syncthreads();  // staging filled

    // out of the staging buffer: the tile (J, I) as the transpose of (I, J);
    // a diagonal tile whole, its upper half from its lower half
    const int i0 = row0 + 4 * tx;  // output columns
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = ty + 16 * m, i = col0 + r;  // output row
      float val[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int lc = 4 * tx + c;
        val[c] = diag && r >= lc ? S[r * ST + lc] : S[lc * ST + r];
      }
      if (i < n) {
        float* dst = Kb + (size_t)i * n + i0;
        if (vec && i0 < n) {
          *reinterpret_cast<float4*>(dst) = make_float4(val[0], val[1], val[2], val[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            if (i0 + c < n) dst[c] = val[c];
          }
        }
      }
    }
  }
}

// Launch geometry shared with K2 (gram_bwd_kernel): 32x8 threads, bands of
// 32 rows.
constexpr int kGramTile = 32;
constexpr int kGramRowsPerPass = 8;    // blockDim = (32, 8)
constexpr int kGramThreads = kGramTile * kGramRowsPerPass;

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
