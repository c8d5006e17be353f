// K14: L^-1 of SPD matrices by Cholesky and forward substitution.
//
// Replaces scenelib2_tpu/kernels/pallas_linalg.py
// (pallas_chol_inv_lower / _chol_inv_kernel, body chol_linv_body), which the
// split route of the single-stream step runs inside the joint EKF update
// (core/ekf.py::joint_update, reference kalman.cpp:104-107) once D > 384.
// The plain PyTorch twin is scenelib2_torch/kernels/chol_inv.py::chol_linv;
// the recurrences are chol_linv.cuh, shared with K3, so the sums run in the
// same order here and there (built with -fmad=false).
//
// Bound on an H100 at M = 20: 1.6 KB in and out and ~5 k operations, a few
// nanoseconds; the launch and the 2M dependent steps of the recurrence are
// the whole cost. Design: at the M of the register form (CHOL_REG_M, which
// the wrapper has the build set to the M of its matrices where M <= 32)
// one warp a matrix and K14_WARPS matrices a CTA, the matrix in the warp's
// registers (chol_linv_reg: a step is a few shuffles and two divisions, no
// barrier); at any other M up to 128 one block of 256 threads a matrix, S,
// U and X in shared memory (chol_linv_block, a block-wide pass between
// barriers a step). A leading batch dimension becomes the grid.
#include <cuda_runtime.h>

#include "chol_linv.cuh"

#define K14_THREADS 256
#define K14_WARPS 4  // matrices a CTA of the warp form
#define K14_MAX_M 128

__global__ void __launch_bounds__(32 * K14_WARPS)
k14_warp_kernel(const float* __restrict__ S, float* __restrict__ Linv, int n, int M) {
  const int m = blockIdx.x * K14_WARPS + (threadIdx.x >> 5);
  if (m >= n) return;  // the whole warp
  const size_t base = (size_t)m * M * M;
  chol_linv_reg_any(S + base, Linv + base, M);
}

__global__ void __launch_bounds__(K14_THREADS)
k14_kernel(const float* __restrict__ S, float* __restrict__ Linv, int M) {
  extern __shared__ float dyn[];
  float* A = dyn;            // [M][M]
  float* U = A + M * M;      // [M][M]
  float* X = U + M * M;      // [M][M]
  const size_t base = (size_t)blockIdx.x * M * M;
  for (int e = threadIdx.x; e < M * M; e += blockDim.x) A[e] = S[base + e];
  __syncthreads();
  chol_linv_block(A, U, X, M);
  for (int e = threadIdx.x; e < M * M; e += blockDim.x) Linv[base + e] = X[e];
}

// n matrices [n][M][M] in, their L^-1 [n][M][M] out
extern "C" int k14_chol_inv(const float* S, float* Linv, int n, int M, void* stream) {
  if (M < 1 || M > K14_MAX_M) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  if (chol_linv_reg_sized(M)) {
    k14_warp_kernel<<<(n + K14_WARPS - 1) / K14_WARPS, 32 * K14_WARPS, 0, (cudaStream_t)stream>>>(S, Linv, n, M);
    return (int)cudaGetLastError();
  }
  const size_t smem = sizeof(float) * 3 * (size_t)M * M;
  // above 48 KB (M > 64) the kernel must opt in; the attribute belongs to
  // the current device, so it is set on every such launch (a cheap host call)
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k14_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k14_kernel<<<n, K14_THREADS, smem, (cudaStream_t)stream>>>(S, Linv, M);
  return (int)cudaGetLastError();
}
