// L^-1 of an SPD matrix by Cholesky and forward substitution, by a block or
// by one warp.
//
// The recurrences of scenelib2_tpu/kernels/pallas_linalg.py::chol_linv_body:
// a right-looking factorisation with the factor stored transposed
// (U = L', inv_sqrt = 1 / sqrt(d), A -= dcol (drow / d)), then forward
// substitution L X = I with each row sum taken in ascending order. The
// plain PyTorch twin is scenelib2_torch/kernels/chol_inv.py::chol_linv; the
// operations run in the same order (built with -fmad=false).
//
// A [M][M] holds S on entry and is overwritten; U and X are M x M of shared
// memory; X = L^-1 on return (its upper triangle exact zeros).
// chol_linv_block (every thread of the block calls it): each factorisation
// or substitution step is one block-wide pass between barriers (K14,
// chol_inv.cu, and K3 at M > 32). chol_linv_warp: the same operations on the
// same entries in the same order by one warp (K3, ekf_update.cu, at M <= 32),
// lane l owning column l: one __syncwarp a factorisation step; the
// substitution needs none (row i of column l reads only column l). Both
// forms are bound by latency, the M dependent steps (PERF.md, PR 7).
#pragma once

__device__ inline void chol_linv_block(float* A, float* U, float* X, int M) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // ---- Cholesky, right-looking, factor stored transposed
  for (int j = 0; j < M; ++j) {
    const float d = A[j * M + j];
    const float inv_sqrt = 1.0f / sqrtf(d);
    for (int l = j + tid; l < M; l += nt) U[j * M + l] = A[j * M + l] * inv_sqrt;
    const int nb = M - 1 - j;
    for (int e = tid; e < nb * nb; e += nt) {
      const int r = j + 1 + e / nb, l = j + 1 + e % nb;
      A[r * M + l] = A[r * M + l] - A[r * M + j] * (A[j * M + l] / d);
    }
    __syncthreads();
  }
  // ---- X = L^-1 by forward substitution, row sums ascending
  for (int i = 0; i < M; ++i) {
    for (int l = tid; l < M; l += nt) {
      float contrib = 0.0f;
      if (i > 0) {
        contrib = U[i] * X[l];  // U[0][i] * X[0][l]
        for (int r = 1; r < i; ++r) contrib = contrib + U[r * M + i] * X[r * M + l];
      }
      X[i * M + l] = ((i == l ? 1.0f : 0.0f) - contrib) / U[i * M + i];
    }
    __syncthreads();
  }
}

// one warp (the caller's lanes 0..31 all call it), M <= 32. The
// substitution keeps column l of X in registers and stores it at the end,
// so that no load of U waits behind a store to X.
__device__ inline void chol_linv_warp(float* A, float* U, float* X, int M) {
  const int l = threadIdx.x & 31;
  for (int j = 0; j < M; ++j) {
    const float d = A[j * M + j];
    const float inv_sqrt = 1.0f / sqrtf(d);
    if (l >= j && l < M) U[j * M + l] = A[j * M + l] * inv_sqrt;
    if (l > j && l < M) {
      const float q = A[j * M + l] / d;  // the block form's (A[j][l] / d), the same quotient
      for (int r = j + 1; r < M; ++r) A[r * M + l] = A[r * M + l] - A[r * M + j] * q;
    }
    __syncwarp();
  }
  float xc[32];  // column l of X
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (i < M) {
      float contrib = 0.0f;
      if (i > 0) {
        contrib = U[i] * xc[0];  // U[0][i] * X[0][l]
#pragma unroll
        for (int r = 1; r < i; ++r) contrib = contrib + U[r * M + i] * xc[r];
      }
      xc[i] = ((i == l ? 1.0f : 0.0f) - contrib) / U[i * M + i];
    }
  }
#pragma unroll
  for (int i = 0; i < 32; ++i)
    if (i < M && l < M) X[i * M + l] = xc[i];
  __syncwarp();
}
