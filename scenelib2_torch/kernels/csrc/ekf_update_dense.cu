// K15: fused joint EKF update + quaternion-norm transform + select + delete +
//      symmetrize, with H, nu and R given dense.
//
// Replaces scenelib2_tpu/kernels/pallas_ekf.py (pallas_joint_update_norm /
// _update_kernel, pallas_call at pallas_ekf.py:150, kernel :39-114): S = H P
// H' + R; L^-1, S^-1, W = P H' S^-1, x' = x + W nu, P' = P - (W S) W' and
// the quaternion-norm transform of P' (update_tail.cuh: the operations K3
// runs from S on, in one block); the prior where any_succ is false; the keep mask as a
// multiply (P * keep keep', x * keep: a NaN in a deleted row stays NaN, as
// in the TPU kernel); P/2 + P'/2, P' formed as the TPU kernel forms it, the
// product P I (a non-finite entry spreads NaN along its row of P'). The
// plain PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::joint_update_dense_plain; every sum
// runs left to right in the same order (built with -fmad=false).
//
// Bound on an H100 at D = 109, M = 20: ~0.1 MB in and out and ~2 MFLOP (the
// dense P H' and H (P H') sum over all D state dimensions), a microsecond at
// most; the M dependent factorisation steps and the launch dominate. Design:
// one block of 512 threads; P H', W, W S and the M x M matrices in a global
// workspace that the wrapper allocates (at D = M = 128 they would need 512
// KB, beyond shared memory; the block's L1 / L2 serve them); each step one
// block-wide pass between barriers.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "update_tail.cuh"

#define K15_THREADS 512
#define K15_MAX 128

__global__ void __launch_bounds__(K15_THREADS)
k15_kernel(const float* __restrict__ x, const float* __restrict__ P, const float* __restrict__ H,
           const float* __restrict__ nu, const float* __restrict__ R, const uint8_t* __restrict__ any_succ,
           const uint8_t* __restrict__ keep, float* __restrict__ xo, float* __restrict__ Po, float* ws,
           int D, int M) {
  float* PHt = ws;               // [D][M]
  float* W = PHt + D * M;        // [D][M]
  float* WS = W + D * M;         // [D][M]
  float* cols = WS + D * M;      // [D][4]
  float* rowsb = cols + D * 4;   // [4][D]
  float* xu = rowsb + 4 * D;     // [D]
  float* S = xu + D;             // [M][M]
  float* A = S + M * M;          // [M][M]
  float* U = A + M * M;          // [M][M]
  float* X = U + M * M;          // [M][M]
  float* Sinv = X + M * M;       // [M][M]
  const int tid = threadIdx.x, nt = blockDim.x;

  if (any_succ[0] != 0) {
    // ---- P H' over every state dimension, ascending
    for (int e = tid; e < D * M; e += nt) {
      const int d = e / M, m = e - d * M;
      const float* Pr = P + (size_t)d * D;
      const float* Hr = H + (size_t)m * D;
      float acc = Pr[0] * Hr[0];
      for (int k = 1; k < D; ++k) acc = acc + Pr[k] * Hr[k];
      PHt[e] = acc;
    }
    __syncthreads();
    // ---- S = H (P H') + R
    for (int e = tid; e < M * M; e += nt) {
      const int m = e / M, n = e - m * M;
      const float* Hr = H + (size_t)m * D;
      float acc = Hr[0] * PHt[n];
      for (int k = 1; k < D; ++k) acc = acc + Hr[k] * PHt[k * M + n];
      S[e] = acc + R[e];
      A[e] = S[e];
      U[e] = 0.0f;
    }
    __syncthreads();
    update_tail(x, P, PHt, S, nu, A, U, X, Sinv, W, WS, cols, rowsb, xu, Po, D, M);
  } else {
    // no match at all: the prior passes through
    for (int e = tid; e < D * D; e += nt) Po[e] = P[e];
    for (int d = tid; d < D; d += nt) xu[d] = x[d];
  }
  __syncthreads();

  // ---- the keep mask (a multiply), then P = P/2 + P'/2 with P' = P I as the
  // TPU kernel forms it: a non-finite entry of column k (times a 0 of I)
  // makes row k of P' NaN except where it meets the 1 of I
  __shared__ int colbad[K15_MAX];  // non-finite entries of each column after the mask
  for (int d = tid; d < D; d += nt) xo[d] = xu[d] * (keep[d] ? 1.0f : 0.0f);
  for (int k = tid; k < D; k += nt) {
    int n = 0;
    for (int i = 0; i < D; ++i) {
      const float v = Po[(size_t)i * D + k] * ((keep[i] ? 1.0f : 0.0f) * (keep[k] ? 1.0f : 0.0f));
      n += !isfinite(v);
    }
    colbad[k] = n;
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e - i * D;
    if (i > j) continue;
    const float k2 = (keep[i] ? 1.0f : 0.0f) * (keep[j] ? 1.0f : 0.0f);
    const float a = Po[(size_t)i * D + j] * k2;  // P[i][j]
    const float b = Po[(size_t)j * D + i] * k2;  // P[j][i]
    const float ta = colbad[i] - !isfinite(b) > 0 ? nanf("") : b;  // P'[i][j]
    const float tb = colbad[j] - !isfinite(a) > 0 ? nanf("") : a;  // P'[j][i]
    Po[(size_t)i * D + j] = a * 0.5f + ta * 0.5f;
    Po[(size_t)j * D + i] = b * 0.5f + tb * 0.5f;
  }
}

// x [D], P [D][D], H [M][D], nu [M], R [M][M], any_succ [1], keep [D] ->
// xo [D], Po [D][D]; ws: ekf_update.py::dense_workspace_floats(D, M) floats
extern "C" int k15_joint_update_dense(const float* x, const float* P, const float* H, const float* nu,
                                      const float* R, const uint8_t* any_succ, const uint8_t* keep,
                                      float* xo, float* Po, float* ws, int D, int M, void* stream) {
  if (D < 7 || D > K15_MAX || M < 1 || M > K15_MAX) return (int)cudaErrorInvalidValue;
  k15_kernel<<<1, K15_THREADS, 0, (cudaStream_t)stream>>>(x, P, H, nu, R, any_succ, keep, xo, Po, ws, D, M);
  return (int)cudaGetLastError();
}
