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
// nanoseconds; the launch and the 2M dependent steps of the recurrence
// (each a block-wide pass between barriers) are the whole cost. Design: one
// block of 256 threads per matrix (the JAX kernel takes one; a leading
// batch dimension becomes the grid); S, U and X live in shared memory.
#include <cuda_runtime.h>

#include "chol_linv.cuh"

#define K14_THREADS 256
#define K14_MAX_M 128

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
  const size_t smem = sizeof(float) * 3 * (size_t)M * M;
  // above 48 KB (M > 64) the kernel must opt in; the attribute belongs to
  // the current device, so it is set on every launch (a cheap host call)
  cudaError_t e = cudaFuncSetAttribute(k14_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k14_kernel<<<n, K14_THREADS, smem, (cudaStream_t)stream>>>(S, Linv, M);
  return (int)cudaGetLastError();
}
