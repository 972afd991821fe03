// C entry point for K1 (gram.cuh). Built with nvcc into one shared library
// with chol.cu and loaded with ctypes (medgp_tpu_torch/ops/cuda_build.py).
// Returns cudaGetLastError() after the launch; the launch is asynchronous
// on the caller's stream.
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

extern "C" const char* medgp_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
