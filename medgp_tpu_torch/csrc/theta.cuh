// The θ prologue and gradient epilogue of the LMC-SM MAP objective
// (medgp_tpu_torch/ops/objective.py:LMCSMObjective), one launch each.
//
// They replace no TPU kernel: the JAX package leaves this glue to XLA,
// which fuses it into the program around the Pallas kernels. Run eagerly,
// the same glue was ~100 small launches and ~50 autograd nodes per
// objective call; these two kernels are that glue, one CTA per batch row.
//
//   prologue: theta (batch, H) and the prior -> B_q = A_q A_q^T + diag(kappa_q)
//             (batch, Q, D, D), mu and v (batch, Q), the per-observation noise
//             sigma^2_{meta_i} mask_i and y_i mask_i (batch, n), the log prior
//             over the active normal and Laplace hypers (batch,), and the
//             number of valid observations (batch,);
//   epilogue: d_value, K2's dB, dmu, dv, the diagonal of K4's dKm, the jitter
//             multiplier, theta and the prior -> dtheta (batch, H):
//               dA_q        = (dB_q + dB_q^T) A_q
//               d log kappa = diag(dB_q) kappa_q
//               d log mu    = dmu mu,  d log v = dv v
//               d log sigma_d = 2 sigma_d^2 sum_{i: meta_i = d} mult dKm_ii mask_i
//             less d_value times the log prior's gradient (through exp where
//             the hyper is exp-transformed; the Laplace term takes sign 0 at
//             0, as autograd's abs does); 0 on rows that are not ok.
//
// Theta's layout is the reference's packing (models/params.py):
// [log sigma (D) | A (Q D R) | log mu (Q) | log v (Q) | log kappa (Q D)].
//
// What bounds them on this card: nothing of the card. A row is O(Q D^2 R +
// n + H) flops and bytes (at Q = 5, D = 24, R = 8, n = 512: 23k FMAs and
// ~25 KB for the prologue); the epilogue reads n diagonal entries of dKm,
// one 4-byte load in each (n+1)*4-byte stride. At a batch of 128 both are
// a few microseconds, under a launch's own cost; what they remove is the
// host's cost of the launches they replace.
//
// What the design does about it: one CTA per row, 256 threads; every sum
// runs in an order fixed by the inputs (per-thread strided partials, then
// a shared-memory tree or a warp's xor butterfly), with no float atomics,
// so a row's result does not depend on the run or on its batch mates.
#pragma once

namespace medgp {

constexpr int kThetaThreads = 256;
constexpr int kThetaWarps = kThetaThreads / 32;
constexpr unsigned kThetaWarpMask = 0xffffffffu;
constexpr int kPriorNormal = 1;   // models/priors.py:PRIOR_NORMAL
constexpr int kPriorLaplace = 2;  // models/priors.py:PRIOR_LAPLACE
// 2 * REF_PI as the port's log_prior multiplies it into a float32 scale
constexpr float kTwoRefPi = 6.2831853f;

// One row's prior, or none (active == nullptr). A prior shared by every
// row has stride 0, a batched one stride H.
struct PriorRow {
  const unsigned char* active;
  const unsigned char* exp_tf;
  const int* ptype;
  const float* loc;
  const float* scale;

  __device__ bool selected(int j) const {
    const int ty = ptype[j];
    return active[j] && (ty == kPriorNormal || ty == kPriorLaplace);
  }
};

__device__ inline PriorRow prior_row(const unsigned char* active, const unsigned char* exp_tf,
                                     const int* ptype, const float* loc, const float* scale,
                                     size_t offset) {
  if (active == nullptr) return PriorRow{nullptr, nullptr, nullptr, nullptr, nullptr};
  return PriorRow{active + offset, exp_tf + offset, ptype + offset, loc + offset,
                  scale + offset};
}

// log_prior's sanitised scale: clamped below at 1e-300, which is 0 in
// float32 (NaN stays NaN, as torch.clamp keeps it)
__device__ inline float prior_scale(float s) { return s < 0.0f ? 0.0f : s; }

// Dynamic shared memory of theta_prologue_kernel in floats: sigma^2 per
// output, then two rows of per-thread partial sums.
__host__ __device__ inline int theta_prologue_smem_floats(int D) {
  return D + 2 * kThetaThreads;
}

__global__ void __launch_bounds__(kThetaThreads) theta_prologue_kernel(
    const float* __restrict__ theta,          // (batch, H)
    const float* __restrict__ y,              // (batch, n)
    const int* __restrict__ meta,             // (batch, n)
    const float* __restrict__ mask,           // (batch, n)
    const unsigned char* __restrict__ p_active,  // (H,) or (batch, H); nullptr: no prior
    const unsigned char* __restrict__ p_exp,
    const int* __restrict__ p_type,
    const float* __restrict__ p_loc,
    const float* __restrict__ p_scale,
    int prior_stride,                         // 0 (shared) or H (batched)
    float* __restrict__ B,                    // (batch, Q, D, D)
    float* __restrict__ mu,                   // (batch, Q)
    float* __restrict__ v,                    // (batch, Q)
    float* __restrict__ noise,                // (batch, n)
    float* __restrict__ y_eff,                // (batch, n)
    float* __restrict__ lp,                   // (batch,)
    float* __restrict__ n_eff,                // (batch,)
    int n, int Q, int D, int R) {
  extern __shared__ float smem[];
  float* s2 = smem;                       // (D,)
  float* red = smem + D;                  // (2, kThetaThreads)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int H = D + Q * (D * R + 2 + D);
  const float* th = theta + (size_t)b * H;
  const float* A = th + D;
  const float* lmu = A + Q * D * R;
  const float* lv = lmu + Q;
  const float* lk = lv + Q;
  for (int d = tid; d < D; d += kThetaThreads) {
    const float s = expf(th[d]);
    s2[d] = s * s;
  }
  for (int q = tid; q < Q; q += kThetaThreads) {
    mu[(size_t)b * Q + q] = expf(lmu[q]);
    v[(size_t)b * Q + q] = expf(lv[q]);
  }
  // B_q[d][e] and B_q[e][d] take the same products in the same order, so
  // B_q is symmetric bitwise
  const int DD = D * D;
  float* Bb = B + (size_t)b * Q * DD;
  for (int idx = tid; idx < Q * DD; idx += kThetaThreads) {
    const int q = idx / DD, d = (idx / D) % D, e = idx % D;
    const float* Ad = A + (q * D + d) * R;
    const float* Ae = A + (q * D + e) * R;
    float s = 0.0f;
    for (int r = 0; r < R; ++r) s = fmaf(Ad[r], Ae[r], s);
    if (d == e) s += expf(lk[q * D + d]);
    Bb[idx] = s;
  }
  __syncthreads();  // s2
  const size_t row = (size_t)b * n;
  float cnt = 0.0f;
  for (int i = tid; i < n; i += kThetaThreads) {
    const float m = mask[row + i];
    noise[row + i] = s2[meta[row + i]] * m;
    y_eff[row + i] = y[row + i] * m;
    cnt += m;
  }
  const PriorRow pr = prior_row(p_active, p_exp, p_type, p_loc, p_scale,
                                (size_t)b * prior_stride);
  float acc = 0.0f;
  if (pr.active != nullptr) {
    for (int j = tid; j < H; j += kThetaThreads) {
      if (!pr.selected(j)) continue;
      const float h = pr.exp_tf[j] ? expf(th[j]) : th[j];
      const float diff = h - pr.loc[j];
      const float sc = prior_scale(pr.scale[j]);
      acc += pr.ptype[j] == kPriorNormal
                 ? -(diff * diff) / (2.0f * sc) - 0.5f * logf(kTwoRefPi * sc)
                 : -fabsf(diff) / sc - logf(2.0f * sc);
    }
  }
  red[tid] = acc;
  red[kThetaThreads + tid] = cnt;
  __syncthreads();
  for (int s = kThetaThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      red[tid] += red[tid + s];
      red[kThetaThreads + tid] += red[kThetaThreads + tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    lp[b] = red[0];
    n_eff[b] = red[kThetaThreads];
  }
}

// Dynamic shared memory of theta_epilogue_kernel in floats: the row's dB
// stack, then d sigma^2 per output.
__host__ __device__ inline int theta_epilogue_smem_floats(int Q, int D) {
  return Q * D * D + D;
}

__global__ void __launch_bounds__(kThetaThreads) theta_epilogue_kernel(
    const float* __restrict__ theta,          // (batch, H)
    const float* __restrict__ dB,             // (batch, Q, D, D)
    const float* __restrict__ dmu,            // (batch, Q)
    const float* __restrict__ dv,             // (batch, Q)
    const float* __restrict__ dKm,            // (batch, n, n): its diagonal is read
    const int* __restrict__ mult,             // (batch,) jitter multiplier
    const int* __restrict__ meta,             // (batch, n)
    const float* __restrict__ mask,           // (batch, n)
    const float* __restrict__ d_value,        // (batch,)
    const unsigned char* __restrict__ ok,     // (batch,)
    const unsigned char* __restrict__ p_active,
    const unsigned char* __restrict__ p_exp,
    const int* __restrict__ p_type,
    const float* __restrict__ p_loc,
    const float* __restrict__ p_scale,
    int prior_stride,
    float* __restrict__ dtheta,               // (batch, H)
    int n, int Q, int D, int R) {
  extern __shared__ float smem[];
  const int DD = D * D;
  float* dBs = smem;           // (Q, D, D)
  float* ds2 = smem + Q * DD;  // (D,)
  const int b = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int H = D + Q * (D * R + 2 + D);
  float* out = dtheta + (size_t)b * H;
  if (!ok[b]) {
    for (int j = tid; j < H; j += kThetaThreads) out[j] = 0.0f;
    return;
  }
  for (int idx = tid; idx < Q * DD; idx += kThetaThreads) dBs[idx] = dB[(size_t)b * Q * DD + idx];
  // the noise cotangent per output: each lane sums its strided share of the
  // row in order, then the warp's xor butterfly; lane 0's sum is kept
  const float m = (float)mult[b];
  const size_t row = (size_t)b * n;
  const float* dK = dKm + (size_t)b * n * n;
  for (int d = warp; d < D; d += kThetaWarps) {
    float s = 0.0f;
    for (int i = lane; i < n; i += 32) {
      if (meta[row + i] == d) s += (m * dK[(size_t)i * (n + 1)]) * mask[row + i];
    }
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kThetaWarpMask, s, off);
    if (lane == 0) ds2[d] = s;
  }
  __syncthreads();
  const float c = d_value[b];
  const float* th = theta + (size_t)b * H;
  const float* A = th + D;
  const int nA = Q * D * R;
  const PriorRow pr = prior_row(p_active, p_exp, p_type, p_loc, p_scale,
                                (size_t)b * prior_stride);
  for (int j = tid; j < H; j += kThetaThreads) {
    float g;
    if (j < D) {
      const float s = expf(th[j]);
      g = 2.0f * (s * s) * ds2[j];
    } else if (j < D + nA) {
      const int a = j - D, q = a / (D * R), d = (a / R) % D, r = a % R;
      const float* dBq = dBs + q * DD;
      const float* Aq = A + q * D * R;
      float s = 0.0f;
      for (int e = 0; e < D; ++e) s = fmaf(dBq[d * D + e] + dBq[e * D + d], Aq[e * R + r], s);
      g = s;
    } else if (j < D + nA + Q) {
      g = dmu[(size_t)b * Q + (j - D - nA)] * expf(th[j]);
    } else if (j < D + nA + 2 * Q) {
      g = dv[(size_t)b * Q + (j - D - nA - Q)] * expf(th[j]);
    } else {
      const int a = j - D - nA - 2 * Q, q = a / D, d = a % D;
      g = dBs[q * DD + d * D + d] * expf(th[j]);
    }
    if (pr.active != nullptr && pr.selected(j)) {
      const float h = pr.exp_tf[j] ? expf(th[j]) : th[j];
      const float diff = h - pr.loc[j];
      const float sc = prior_scale(pr.scale[j]);
      const float sgn = diff > 0.0f ? 1.0f : (diff < 0.0f ? -1.0f : diff);
      float dl = pr.ptype[j] == kPriorNormal ? -diff / sc : -sgn / sc;
      if (pr.exp_tf[j]) dl *= h;
      g -= c * dl;
    }
    out[j] = g;
  }
}

}  // namespace medgp
