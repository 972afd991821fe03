// C entry points for K1 and K2 (gram.cuh). Built with nvcc into one shared
// library with chol.cu and loaded with ctypes
// (medgp_tpu_torch/ops/cuda_build.py). Each returns cudaGetLastError()
// after its launches; they are asynchronous on the caller's stream.
#include <cuda_runtime.h>

#include "gram.cuh"

// Lets `kernel` take `bytes` of dynamic shared memory on the current
// device beside its static arrays (opt-in where both pass the default
// 48 KB);
// cudaErrorInvalidValue if that exceeds what a block may have. What was
// granted is remembered per (kernel, device), so a launch that needs no
// more asks the runtime nothing.
template <class Kernel>
static cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  struct Grant { const void* fn; int dev; size_t bytes; };
  static Grant granted[64];
  static int n_granted = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const void* fn = (const void*)kernel;
  Grant* g = nullptr;
  for (int i = 0; i < n_granted; ++i) {
    if (granted[i].fn == fn && granted[i].dev == dev) g = &granted[i];
  }
  if (g != nullptr && g->bytes >= bytes) return cudaSuccess;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes fa;
  err = cudaFuncGetAttributes(&fa, kernel);
  if (err != cudaSuccess) return err;
  if (bytes + fa.sharedSizeBytes > (size_t)optin) return cudaErrorInvalidValue;
  if (bytes + fa.sharedSizeBytes > 48 * 1024) {  // past the default, static included
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  if (g == nullptr && n_granted < 64) g = &granted[n_granted++];
  if (g != nullptr) *g = Grant{fn, dev, bytes};
  return cudaSuccess;
}

// K1 over a launch plan (ops/cuda_gram.py:gram_plan): `ctas` CTAs, each a
// run of `items_per_cta` consecutive lower-triangle tile pairs of one
// matrix, so ctas = batch * ceil(pairs / items_per_cta); a plan that does
// not cover every tile pair exactly once is refused.
extern "C" int medgp_gram_lmcsm(const float* t, const int* meta,
                                const float* B, const float* mu,
                                const float* v, const float* mask, float* K,
                                int batch, int n, int Q, int D, int tile,
                                int items_per_cta, int ctas, void* stream) {
  if (batch <= 0 || n <= 0 || Q <= 0 || D <= 0 || tile != medgp::kFwdTile ||
      items_per_cta <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long nt = (n + medgp::kFwdTile - 1) / medgp::kFwdTile;
  const long long pairs = nt * (nt + 1) / 2;
  const long long runs = (pairs + items_per_cta - 1) / items_per_cta;
  if (items_per_cta > pairs || (long long)batch * runs != ctas) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(float) * medgp::gram_fwd_smem_floats(Q, D);
  cudaError_t err = reserve_smem(medgp::gram_lmcsm_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  medgp::gram_lmcsm_kernel<<<(unsigned)ctas, medgp::kFwdThreads, smem,
                             (cudaStream_t)stream>>>(t, meta, B, mu, v, mask,
                                                     K, n, Q, D, items_per_cta,
                                                     (int)runs);
  return (int)cudaGetLastError();
}

// One pass of K2 over dK for components q0 .. q0 + G - 1.
template <int G>
static cudaError_t gram_bwd_pass(const float* dK, const float* t, const int* meta,
                                 const float* B, const float* mu, const float* v,
                                 const float* mask, float* dB_part, float* dmv_part,
                                 int batch, int n, int Q, int D, int q0,
                                 cudaStream_t stream) {
  const size_t smem = sizeof(float) * medgp::gram_bwd_smem_floats(G, D);
  cudaError_t err = reserve_smem(medgp::gram_bwd_kernel<G>, smem);
  if (err != cudaSuccess) return err;
  const int nband = (n + medgp::kGramTile - 1) / medgp::kGramTile;
  dim3 block(medgp::kGramTile, medgp::kGramRowsPerPass);
  medgp::gram_bwd_kernel<G><<<dim3(nband, batch), block, smem, stream>>>(
      dK, t, meta, B, mu, v, mask, dB_part, dmv_part, n, Q, D, q0);
  return cudaGetLastError();
}

// K2, the gram's VJP: one pass per group of up to kBwdQGroup components
// (fewer where the group's tables would not fit a block's shared memory)
// into the per-band partials, then the ordered reduction over bands.
// dB_part (batch, nband, Q, D, D) and dmv_part (batch, nband, 2, Q) are
// workspaces, nband = ceil(n / 32).
extern "C" int medgp_gram_bwd(const float* dK, const float* t, const int* meta,
                              const float* B, const float* mu, const float* v,
                              const float* mask, float* dB_part,
                              float* dmv_part, float* dB, float* dmu,
                              float* dv, int batch, int n, int Q, int D,
                              void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || Q <= 0 || D <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // components per pass: as many as fit a block beside the static arrays
  // (under 4 KB) in the card's 227 KB
  int G = Q < medgp::kBwdQGroup ? Q : medgp::kBwdQGroup;
  while (G > 1 &&
         sizeof(float) * medgp::gram_bwd_smem_floats(G, D) + 4096 > medgp::kSmemPerBlock) {
    --G;
  }
  cudaError_t err = cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  for (int q0 = 0; q0 < Q; q0 += G) {
    const int g = Q - q0 < G ? Q - q0 : G;
    switch (g) {
      case 1: err = gram_bwd_pass<1>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 2: err = gram_bwd_pass<2>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 3: err = gram_bwd_pass<3>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 4: err = gram_bwd_pass<4>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 5: err = gram_bwd_pass<5>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 6: err = gram_bwd_pass<6>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      case 7: err = gram_bwd_pass<7>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
      default: err = gram_bwd_pass<8>(dK, t, meta, B, mu, v, mask, dB_part, dmv_part, batch, n, Q, D, q0, st); break;
    }
    if (err != cudaSuccess) return (int)err;
  }
  const int nband = (n + medgp::kGramTile - 1) / medgp::kGramTile;
  const int per = Q * D * D + 2 * Q;
  const int threads = 256;
  dim3 rgrid((per + threads - 1) / threads, batch);
  medgp::gram_bwd_reduce_kernel<<<rgrid, threads, 0, st>>>(
      dB_part, dmv_part, dB, dmu, dv, nband, Q, D);
  return (int)cudaGetLastError();
}

extern "C" const char* medgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
