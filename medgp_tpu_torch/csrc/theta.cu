// C entry points for the θ prologue and gradient epilogue of the LMC-SM
// objective (theta.cuh). Built with nvcc into one shared library with
// gram.cu and chol.cu and loaded with ctypes
// (medgp_tpu_torch/ops/cuda_build.py). Each returns cudaGetLastError()
// after its asynchronous launch on `stream`. The prior's five pointers are
// all null (no prior) or all set; `prior_stride` is 0 for one prior shared
// by every row, H for one per row.
#include <cuda_runtime.h>

#include "theta.cuh"

static bool theta_shape_ok(int batch, int n, int Q, int D, int R, int prior_stride) {
  const int H = D + Q * (D * R + 2 + D);
  return batch > 0 && n > 0 && Q > 0 && D > 0 && R > 0 &&
         (prior_stride == 0 || prior_stride == H);
}

extern "C" int medgp_theta_prologue(const float* theta, const float* y, const int* meta,
                                    const float* mask, const unsigned char* p_active,
                                    const unsigned char* p_exp, const int* p_type,
                                    const float* p_loc, const float* p_scale,
                                    float* B, float* mu, float* v, float* noise,
                                    float* y_eff, float* lp, float* n_eff, int batch,
                                    int n, int Q, int D, int R, int prior_stride,
                                    void* stream) {
  if (!theta_shape_ok(batch, n, Q, D, R, prior_stride)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * medgp::theta_prologue_smem_floats(D);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  medgp::theta_prologue_kernel<<<(unsigned)batch, medgp::kThetaThreads, smem,
                                 (cudaStream_t)stream>>>(
      theta, y, meta, mask, p_active, p_exp, p_type, p_loc, p_scale, prior_stride, B, mu,
      v, noise, y_eff, lp, n_eff, n, Q, D, R);
  return (int)cudaGetLastError();
}

extern "C" int medgp_theta_epilogue(const float* theta, const float* dB, const float* dmu,
                                    const float* dv, const float* dKm, const int* mult,
                                    const int* meta, const float* mask,
                                    const float* d_value, const unsigned char* ok,
                                    const unsigned char* p_active,
                                    const unsigned char* p_exp, const int* p_type,
                                    const float* p_loc, const float* p_scale,
                                    float* dtheta, int batch, int n, int Q, int D, int R,
                                    int prior_stride, void* stream) {
  if (!theta_shape_ok(batch, n, Q, D, R, prior_stride)) return (int)cudaErrorInvalidValue;
  // the dB stack stays under the default 48 KB up to Q D^2 ~ 12k floats
  // (Q = 5 at D = 48); beyond it the kernel opts in, up to the card's 227 KB
  const size_t smem = sizeof(float) * medgp::theta_epilogue_smem_floats(Q, D);
  if (smem > 48 * 1024) {
    int dev = 0, optin = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
    if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
    err = cudaFuncSetAttribute(medgp::theta_epilogue_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  medgp::theta_epilogue_kernel<<<(unsigned)batch, medgp::kThetaThreads, smem,
                                 (cudaStream_t)stream>>>(
      theta, dB, dmu, dv, dKm, mult, meta, mask, d_value, ok, p_active, p_exp, p_type,
      p_loc, p_scale, prior_stride, dtheta, n, Q, D, R);
  return (int)cudaGetLastError();
}
