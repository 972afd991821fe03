// C entry points for K3 (chol_solve) and K5 (tri_inv), see chol.cuh.
// Each returns cudaGetLastError() after an asynchronous launch on `stream`.
#include <cuda_runtime.h>

#include "chol.cuh"

extern "C" int medgp_chol_solve(const float* K, const float* noise,
                                const float* y, float* L, float* alpha,
                                float* linvd, int batch, int n,
                                void* stream) {
  if (batch <= 0 || n <= 0 || n % medgp::kBS != 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 block(medgp::kBS, medgp::kRowsPerPass);
  medgp::chol_solve_kernel<<<batch, block, 0, (cudaStream_t)stream>>>(
      K, noise, y, L, alpha, linvd, n);
  return (int)cudaGetLastError();
}

extern "C" int medgp_tri_inv(const float* L, const float* linvd, float* X,
                             int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n % medgp::kBS != 0) {
    return (int)cudaErrorInvalidValue;
  }
  dim3 grid(batch, n / medgp::kBS);
  dim3 block(medgp::kBS, medgp::kRowsPerPass);
  medgp::tri_inv_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(L, linvd,
                                                                   X, n);
  return (int)cudaGetLastError();
}
