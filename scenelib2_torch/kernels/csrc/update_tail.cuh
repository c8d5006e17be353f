// The joint EKF update from S on, block-level: L^-1 of S, S^-1, the gain,
// x' and P', and the quaternion-'normalisation' transform of P'.
//
// The part of scenelib2_tpu/kernels/pallas_ekf.py that its two update
// kernels share (_update_kernel, pallas_ekf.py:39-114, and
// _update_kernel_compact): L^-1 by chol_linv_body's recurrences
// (chol_linv.cuh), S^-1 = L^-T L^-1, W = P H' S^-1, x' = x + W nu,
// P' = P - (W S) W', then P' transformed by the reference's qq=|q|^2
// quaternion-norm Jacobian (monoslam.cpp:616-637). The plain PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::update_tail; every sum runs left to
// right in the same order there and here (built with -fmad=false). Included
// by ekf_update_dense.cu (K15); K3 (ekf_update.cu) runs the same operations
// in the same order spread over a thread-block cluster.
//
// Every thread of the block calls it. On entry: PHt [D][M] = P H', S [M][M]
// = H P H' + R and its copy in A, U [M][M] zero, nu [M]; x [D], P [D][D].
// On return: xu [D] = x', Po [D][D] = the transformed P'. X, Sinv [M][M],
// W, WS [D][M], cols [D][4] and rowsb [4][D] are scratch (shared or global
// memory of the block); each step is one block-wide pass between barriers.
#pragma once

#include "chol_linv.cuh"

__device__ inline void update_tail(const float* x, const float* P, const float* PHt, const float* S,
                                   const float* nu, float* A, float* U, float* X, float* Sinv, float* W,
                                   float* WS, float* cols, float* rowsb, float* xu, float* Po, int D,
                                   int M) {
  const int tid = threadIdx.x, nt = blockDim.x;
  // ---- X = L^-1 (chol_linv_body, chol_linv.cuh)
  chol_linv_block(A, U, X, M);
  // ---- S^-1 = L^-T L^-1
  for (int e = tid; e < M * M; e += nt) {
    const int i = e / M, j = e - i * M;
    float acc = X[i] * X[j];
    for (int k = 1; k < M; ++k) acc = acc + X[k * M + i] * X[k * M + j];
    Sinv[e] = acc;
  }
  __syncthreads();
  // ---- W = P H' S^-1
  for (int e = tid; e < D * M; e += nt) {
    const int d = e / M, n = e - d * M;
    float acc = PHt[d * M] * Sinv[n];
    for (int m = 1; m < M; ++m) acc = acc + PHt[d * M + m] * Sinv[m * M + n];
    W[e] = acc;
  }
  __syncthreads();
  // ---- x' = x + W nu;  W S
  for (int d = tid; d < D; d += nt) {
    float acc = nu[0] * W[d * M];
    for (int m = 1; m < M; ++m) acc = acc + nu[m] * W[d * M + m];
    xu[d] = x[d] + acc;
  }
  for (int e = tid; e < D * M; e += nt) {
    const int d = e / M, n = e - d * M;
    float acc = W[d * M] * S[n];
    for (int m = 1; m < M; ++m) acc = acc + W[d * M + m] * S[m * M + n];
    WS[e] = acc;
  }
  __syncthreads();
  // ---- P' = P - (W S) W'
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e - i * D;
    float acc = WS[i * M] * W[j * M];
    for (int m = 1; m < M; ++m) acc = acc + WS[i * M + m] * W[j * M + m];
    Po[e] = P[e] - acc;
  }
  __syncthreads();
  // ---- quaternion-norm transform with the qq=|q|^2 quirk Jacobian
  const float q[4] = {xu[3], xu[4], xu[5], xu[6]};
  const float qq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  float J[4][4];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c)
      J[r][c] = r == c ? (1.0f - q[c] * q[c] / (qq * qq)) / qq : -(q[r] * q[c]) / (qq * qq * qq);
  for (int e = tid; e < D * 4; e += nt) {
    const int i = e >> 2, c = e & 3;
    const float* Pr = Po + (size_t)i * D;
    float acc = Pr[3] * J[c][0];
    for (int k = 1; k < 4; ++k) acc = acc + Pr[3 + k] * J[c][k];
    cols[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < 4 * D; e += nt) {
    const int r = e / D, j = e - r * D;
    float acc = 0.0f;
    for (int k = 0; k < 4; ++k) {
      const float pt = (j >= 3 && j < 7) ? cols[(3 + k) * 4 + (j - 3)] : Po[(size_t)(3 + k) * D + j];
      const float t = J[r][k] * pt;
      acc = k == 0 ? t : acc + t;
    }
    rowsb[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e - i * D;
    if (i >= 3 && i < 7) Po[e] = rowsb[(i - 3) * D + j];
    else if (j >= 3 && j < 7) Po[e] = cols[i * 4 + (j - 3)];
  }
}
