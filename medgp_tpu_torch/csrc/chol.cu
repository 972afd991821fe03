// C entry points for K3 (chol_solve), K5 (tri_inv), see chol.cuh, and K4
// (qmat), see qmat.cuh. Each returns cudaGetLastError() after its
// asynchronous launches on `stream`.
#include <cuda_runtime.h>

#include "chol.cuh"
#include "qmat.cuh"

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

// out = coef * (L^{-T} L^{-1} - alpha alpha^T); X is an (batch, n, n)
// workspace that receives L^{-1}.
extern "C" int medgp_qmat(const float* L, const float* linvd,
                          const float* alpha, const float* coef, float* X,
                          float* out, int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n % medgp::kBS != 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const int code = medgp_tri_inv(L, linvd, X, batch, n, stream);
  if (code != 0) return code;
  const int nt = (n + medgp::kSyTile - 1) / medgp::kSyTile;
  dim3 grid(nt * (nt + 1) / 2, batch);
  dim3 block(medgp::kSyDim, medgp::kSyDim);
  medgp::qmat_syrk_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      X, alpha, coef, out, n);
  return (int)cudaGetLastError();
}
