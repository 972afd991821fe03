// C entry points for K1 and K2 (gram.cuh). Built with nvcc into one shared
// library with chol.cu and loaded with ctypes
// (medgp_tpu_torch/ops/cuda_build.py). Each returns cudaGetLastError()
// after its launches; they are asynchronous on the caller's stream.
#include <cuda_runtime.h>

#include "gram.cuh"

extern "C" int medgp_gram_lmcsm(const float* t, const int* meta,
                                const float* B, const float* mu,
                                const float* v, const float* mask, float* K,
                                int batch, int n, int Q, int D,
                                void* stream) {
  if (Q * D * D > medgp::kMaxBStack) return (int)cudaErrorInvalidValue;
  const long long ntile = (n + medgp::kGramTile - 1) / medgp::kGramTile;
  const long long blocks = (long long)batch * ntile * ntile;
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 block(medgp::kGramTile, medgp::kGramRowsPerPass);
  medgp::gram_lmcsm_kernel<<<(unsigned)blocks, block, 0,
                             (cudaStream_t)stream>>>(t, meta, B, mu, v, mask,
                                                     K, n, Q, D);
  return (int)cudaGetLastError();
}

// K2, the gram's VJP: one pass per group of up to kBwdQGroup components
// into the per-band partials, then the ordered reduction over bands.
// dB_part (batch, nband, Q, D, D) and dmv_part (batch, nband, 2, Q) are
// workspaces, nband = ceil(n / 32).
extern "C" int medgp_gram_bwd(const float* dK, const float* t, const int* meta,
                              const float* B, const float* mu, const float* v,
                              const float* mask, float* dB_part,
                              float* dmv_part, float* dB, float* dmu,
                              float* dv, int batch, int n, int Q, int D,
                              void* stream) {
  if (batch <= 0 || batch > 65535 || n <= 0 || Q <= 0 || D <= 0 ||
      D > medgp::kBwdMaxD) {
    return (int)cudaErrorInvalidValue;
  }
  const int nband = (n + medgp::kGramTile - 1) / medgp::kGramTile;
  const int G0 = Q < medgp::kBwdQGroup ? Q : medgp::kBwdQGroup;
  const size_t max_smem = sizeof(float) * medgp::gram_bwd_smem_floats(G0, D);
  if (max_smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        medgp::gram_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)max_smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 block(medgp::kGramTile, medgp::kGramRowsPerPass);
  for (int q0 = 0; q0 < Q; q0 += medgp::kBwdQGroup) {
    const int G = Q - q0 < medgp::kBwdQGroup ? Q - q0 : medgp::kBwdQGroup;
    const size_t smem = sizeof(float) * medgp::gram_bwd_smem_floats(G, D);
    medgp::gram_bwd_kernel<<<dim3(nband, batch), block, smem,
                             (cudaStream_t)stream>>>(
        dK, t, meta, B, mu, v, mask, dB_part, dmv_part, n, Q, D, q0, G);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  const int per = Q * D * D + 2 * Q;
  const int threads = 256;
  dim3 rgrid((per + threads - 1) / threads, batch);
  medgp::gram_bwd_reduce_kernel<<<rgrid, threads, 0, (cudaStream_t)stream>>>(
      dB_part, dmv_part, dB, dmu, dv, nband, Q, D);
  return (int)cudaGetLastError();
}

extern "C" const char* medgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
