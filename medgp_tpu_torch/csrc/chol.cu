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

// K5's level launches: CTAs per cluster for level w, the least power of two
// that gives the launch kLvTargetCtas CTAs, at most the level's row tiles
// (w / 128) and the portable cluster size. The result does not depend on it.
constexpr long long kLvTargetCtas = 4 * 132;

static int level_cluster(int batch, int npairs, int w) {
  const long long base = (long long)batch * npairs * (w / medgp::kLvBN);
  const int cap = w / medgp::kLvBM < medgp::kLvMaxCluster ? w / medgp::kLvBM
                                                          : medgp::kLvMaxCluster;
  int c = 1;
  while (2 * c <= cap && base * c < kLvTargetCtas) c *= 2;
  return c;
}

// K5: tri_inv_diag_kernel once, then tri_inv_level_kernel for w = 128,
// 256, ... < n: 1 + ceil(log2(n / 128)) launches.
extern "C" int medgp_tri_inv(const float* L, const float* linvd, float* X,
                             int batch, int n, void* stream) {
  if (batch <= 0 || n <= 0 || n % medgp::kBS != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t diag_smem = medgp::kDiagSmemFloats * sizeof(float);
  static bool granted[64] = {};  // the diagonal kernel's shared memory, per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !granted[dev]) {
    err = cudaFuncSetAttribute(medgp::tri_inv_diag_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)diag_smem);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) granted[dev] = true;
  }
  const long long nsb = (n + medgp::kW0 - 1) / medgp::kW0;
  if (batch * nsb > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  medgp::tri_inv_diag_kernel<<<(unsigned)(batch * nsb), medgp::kDiagThreads, diag_smem, st>>>(
      L, linvd, X, n);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  for (int w = medgp::kW0; w < n; w *= 2) {
    const int npairs = (n - w + 2 * w - 1) / (2 * w);  // pairs with a second block
    const int cluster = level_cluster(batch, npairs, w);
    const long long ctas = (long long)batch * npairs * (w / medgp::kLvBN) * cluster;
    if (ctas > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)ctas);
    cfg.blockDim = dim3(medgp::kLvThreads);
    cfg.dynamicSmemBytes = 0;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, medgp::tri_inv_level_kernel, L, X, n, w, npairs, batch);
    if (err != cudaSuccess) return (int)err;
  }
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
  medgp::qmat_syrk_kernel<<<grid, medgp::kSyThreads, 0, (cudaStream_t)stream>>>(
      X, alpha, coef, out, n);
  return (int)cudaGetLastError();
}
