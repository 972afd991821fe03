// C entry points for K3 (chol_solve), K5 (tri_inv), see chol.cuh, and K4
// (qmat), see qmat.cuh. Each returns cudaGetLastError() after its
// asynchronous launches on `stream`.
#include <cuda_runtime.h>

#include "chol.cuh"
#include "qmat.cuh"

// K3 on `cluster` CTAs per matrix, one thread-block cluster each. Returns
// kClusterDoesNotFit when cudaOccupancyMaxActiveClusters says that no such
// cluster fits on the card (no launch is made).
constexpr int kClusterDoesNotFit = -1;

extern "C" int medgp_chol_solve(const float* K, const float* noise,
                                const float* y, float* L, float* alpha,
                                float* linvd, int batch, int n, int cluster,
                                void* stream) {
  if (batch <= 0 || n <= 0 || n % medgp::kBS != 0 || cluster < 1 ||
      cluster > medgp::kCholMaxCluster ||
      (long long)batch * cluster > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(batch * cluster));
  cfg.blockDim = dim3(medgp::kBS, medgp::kRowsPerPass);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // whether a cluster of this size fits, asked once per (device, size)
  static signed char fits[64][medgp::kCholMaxCluster + 1] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  signed char* known = dev < 64 ? &fits[dev][cluster] : nullptr;
  if (known == nullptr || *known == 0) {
    if (cluster > 8) {
      err = cudaFuncSetAttribute(medgp::chol_solve_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
    }
    int active = 0;
    err = cudaOccupancyMaxActiveClusters(&active, medgp::chol_solve_kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (known != nullptr) *known = active > 0 ? 1 : -1;
    if (active <= 0) return kClusterDoesNotFit;
  } else if (*known < 0) {
    return kClusterDoesNotFit;
  }
  err = cudaLaunchKernelEx(&cfg, medgp::chol_solve_kernel, K, noise, y, L,
                           alpha, linvd, n);
  if (err != cudaSuccess) return (int)err;
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
