// K1: fused EKF predict + per-slot measurement prediction + top-NSEL select.
//
// Replaces scenelib2_tpu/kernels/pallas_predict_measure.py
// (pallas_predict_measure / _predict_measure_kernel). The plain PyTorch twin
// is scenelib2_torch/kernels/predict_measure.py::predict_measure_plain; this
// kernel performs the same float operations in the same order.
//
// Bound on an H100: ~0.1 MB of P in and out and ~0.5 MFLOP at D=109, MF=16,
// far below a microsecond either way; the launch dominates. Design: ONE block
// of 256 threads. Thread 0 builds the 13x13 F and Q of the motion model; all
// threads form the 13 camera rows of F P in shared memory and write P'; one
// thread per slot runs the measurement chain; the selection ranks lanes by
// pairwise comparison.
#include <cuda_runtime.h>
#include <stdint.h>

#include "measure_chain.cuh"

#define CAM_DIM 13
#define SLOT_DIM 6
#define MAX_MF 128
#define K1_THREADS 256

struct K1Params {
  float dt, half_dt, lin_var, ang_var;
  MeasConsts mc;
};

__global__ void __launch_bounds__(K1_THREADS)
k1_kernel(const float* __restrict__ x, const float* __restrict__ P,
          const float* __restrict__ xp_org, const uint8_t* __restrict__ act_full,
          const uint8_t* __restrict__ act_part, float* __restrict__ meas,
          float* __restrict__ sel, float* __restrict__ xo, float* __restrict__ Po,
          int* __restrict__ top_idx, float* __restrict__ top_score,
          int* __restrict__ n_visible, int* __restrict__ pidx,
          uint8_t* __restrict__ pmask, int D, int MF, int NSEL, int MAXP, K1Params p) {
  extern __shared__ float top[];  // [13][D]: camera rows of F P
  __shared__ float F[CAM_DIM][CAM_DIM], Q[CAM_DIM][CAM_DIM], A[CAM_DIM][CAM_DIM],
      Pc[CAM_DIM][CAM_DIM];
  __shared__ float xs[7];
  __shared__ float work[MAX_MF];
  const int tid = threadIdx.x, nt = blockDim.x;

  if (tid == 0) {
    const float dt = p.dt;
    const float r0 = x[0], r1 = x[1], r2 = x[2];
    const float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
    const float v0 = x[7], v1 = x[8], v2 = x[9];
    const float w0 = x[10], w1 = x[11], w2 = x[12];
    // fv (motion_model.cpp:84-117, u = 0)
    xs[0] = r0 + v0 * dt;
    xs[1] = r1 + v1 * dt;
    xs[2] = r2 + v2 * dt;
    const float av0 = w0 * dt, av1 = w1 * dt, av2 = w2 * dt;
    const float angle = sqrtf(av0 * av0 + av1 * av1 + av2 * av2);
    const bool ok_a = angle > 0.0f;
    const float safe = ok_a ? angle : 1.0f;
    const float sfac = ok_a ? sinf(angle / 2.0f) / safe : 0.0f;
    const float qt_w = ok_a ? cosf(angle / 2.0f) : 1.0f;
    const float qt_x = sfac * av0, qt_y = sfac * av1, qt_z = sfac * av2;
    xs[3] = qw * qt_w - qx * qt_x - qy * qt_y - qz * qt_z;
    xs[4] = qw * qt_x + qx * qt_w + qy * qt_z - qz * qt_y;
    xs[5] = qw * qt_y - qx * qt_z + qy * qt_w + qz * qt_x;
    xs[6] = qw * qt_z + qx * qt_y - qy * qt_x + qz * qt_w;

    // dqomegadt_by_domega (motion_model.cpp:290-349, w->0 guarded)
    const float wmod = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
    const bool okw = wmod > 0.0f;
    const float wn = okw ? wmod : 1.0f;
    const float half = p.half_dt;
    const float s_ = sinf(wn * half);
    const float c_ = cosf(wn * half);
    const float w[3] = {w0, w1, w2};
    float dOm[4][3];
    for (int j = 0; j < 3; ++j) dOm[0][j] = okw ? -half * (w[j] / wn) * s_ : 0.0f;
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        const float wA = w[a], wB = w[b];
        float v;
        if (a == b)
          v = okw ? half * (wA * wA) / (wn * wn) * c_ + (1.0f / wn) * (1.0f - wA * wA / (wn * wn)) * s_
                  : half;
        else
          v = okw ? (wA * wB / (wn * wn)) * (half * c_ - (1.0f / wn) * s_) : 0.0f;
        dOm[1 + a][b] = v;
      }
    const float D1[4][4] = {{qw, -qx, -qy, -qz}, {qx, qw, -qz, qy}, {qy, qz, qw, -qx}, {qz, -qy, qx, qw}};
    float M[4][3];
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 3; ++j)
        M[i][j] = D1[i][0] * dOm[0][j] + D1[i][1] * dOm[1][j] + D1[i][2] * dOm[2][j] + D1[i][3] * dOm[3][j];
    const float qb[4][4] = {{qt_w, -qt_x, -qt_y, -qt_z}, {qt_x, qt_w, qt_z, -qt_y},
                            {qt_y, -qt_z, qt_w, qt_x}, {qt_z, qt_y, -qt_x, qt_w}};
    for (int i = 0; i < CAM_DIM; ++i)
      for (int j = 0; j < CAM_DIM; ++j) F[i][j] = i == j ? 1.0f : 0.0f;
    for (int i = 0; i < 3; ++i) F[i][7 + i] = dt;
    for (int i = 0; i < 4; ++i) {
      for (int j = 0; j < 4; ++j) F[3 + i][3 + j] = qb[i][j];
      for (int j = 0; j < 3; ++j) F[3 + i][10 + j] = M[i][j];
    }
    // Q = G Pnn G' (motion_model.cpp:148-217)
    float G[CAM_DIM][6];
    for (int i = 0; i < CAM_DIM; ++i)
      for (int j = 0; j < 6; ++j) G[i][j] = 0.0f;
    for (int i = 0; i < 3; ++i) {
      G[i][i] = dt;
      G[7 + i][i] = 1.0f;
      G[10 + i][3 + i] = 1.0f;
    }
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 3; ++j) G[3 + i][3 + j] = M[i][j];
    const float pnn[6] = {p.lin_var, p.lin_var, p.lin_var, p.ang_var, p.ang_var, p.ang_var};
    for (int i = 0; i < CAM_DIM; ++i)
      for (int j = 0; j < CAM_DIM; ++j) {
        float acc = (G[i][0] * pnn[0]) * G[j][0];
        for (int k = 1; k < 6; ++k) acc = acc + (G[i][k] * pnn[k]) * G[j][k];
        Q[i][j] = acc;
      }
  }
  __syncthreads();

  // top = F P[0:13, :], k ascending
  for (int e = tid; e < CAM_DIM * D; e += nt) {
    const int i = e / D, j = e - i * D;
    float acc = F[i][0] * P[j];
    for (int k = 1; k < CAM_DIM; ++k) acc = acc + F[i][k] * P[k * D + j];
    top[e] = acc;
  }
  __syncthreads();
  for (int e = tid; e < CAM_DIM * CAM_DIM; e += nt) {
    const int i = e / CAM_DIM, j = e - i * CAM_DIM;
    float acc = top[i * D] * F[j][0];
    for (int k = 1; k < CAM_DIM; ++k) acc = acc + top[i * D + k] * F[j][k];
    A[i][j] = acc + Q[i][j];
  }
  __syncthreads();
  for (int e = tid; e < CAM_DIM * CAM_DIM; e += nt) {
    const int i = e / CAM_DIM, j = e - i * CAM_DIM;
    Pc[i][j] = 0.5f * (A[i][j] + A[j][i]);
  }
  __syncthreads();

  // P': camera block Pc, camera rows/cols from top, feature block unchanged
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e - i * D;
    float v;
    if (i < CAM_DIM && j < CAM_DIM) v = Pc[i][j];
    else if (i < CAM_DIM) v = top[i * D + j];
    else if (j < CAM_DIM) v = top[j * D + i];
    else v = P[e];
    Po[e] = v;
  }
  for (int e = tid; e < D; e += nt) xo[e] = e < 7 ? xs[e] : x[e];

  // per-slot measurement chain
  float m[NOUT];
  if (tid < MF) {
    const int off = CAM_DIM + SLOT_DIM * tid;
    float r[3] = {xs[0], xs[1], xs[2]};
    float q[4] = {xs[3], xs[4], xs[5], xs[6]};
    float pxx[7][7], y[3], xpo[7], pxy[7][3], pyy[3][3];
    for (int i = 0; i < 7; ++i)
      for (int j = 0; j < 7; ++j) pxx[i][j] = Pc[i][j];
    for (int j = 0; j < 3; ++j) y[j] = x[off + j];
    for (int j = 0; j < 7; ++j) xpo[j] = xp_org[tid * 7 + j];
    for (int a = 0; a < 7; ++a)
      for (int j = 0; j < 3; ++j) pxy[a][j] = top[a * D + off + j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) pyy[i][j] = P[(off + i) * D + off + j];
    measure_lane(r, q, pxx, y, xpo, pxy, pyy, act_full[tid] != 0, p.mc, m);
    for (int k = 0; k < NOUT; ++k) meas[k * MF + tid] = m[k];
    const float s = m[O_SCORE];
    work[tid] = isfinite(s) ? s : -3e38f;
  }
  __syncthreads();

  // stable descending rank (lax.top_k order: ties to the lowest lane)
  if (tid < MF) {
    const float s = work[tid];
    int rank = 0;
    for (int k2 = 0; k2 < MF; ++k2) {
      const float s2 = work[k2];
      rank += (s2 > s) || (s2 == s && k2 < tid);
    }
    if (rank < NSEL) {
      top_idx[rank] = tid;
      top_score[rank] = s;
      for (int k = 0; k < NOUT; ++k) sel[k * NSEL + rank] = isfinite(m[k]) ? m[k] : 0.0f;
    }
  }
  if (tid == 0) {
    int nv = 0;
    for (int k = 0; k < MF; ++k) nv += (act_full[k] != 0) && (meas[O_VIS * MF + k] == 0.0f);
    *n_visible = nv;
    // the first MAXP partial lanes, lowest first, then the lowest others
    int j = 0;
    for (int pass = 0; pass < 2 && j < MAXP; ++pass)
      for (int k = 0; k < MF && j < MAXP; ++k)
        if ((act_part[k] != 0) == (pass == 0)) {
          pidx[j] = k;
          pmask[j] = pass == 0;
          ++j;
        }
  }
}

extern "C" int k1_predict_measure(const float* x, const float* P, const float* xp_org,
                                  const uint8_t* act_full, const uint8_t* act_part, float* meas,
                                  float* sel, float* xo, float* Po, int* top_idx,
                                  float* top_score, int* n_visible, int* pidx, uint8_t* pmask,
                                  int D, int MF, int NSEL, int MAXP, const K1Params* p,
                                  void* stream) {
  const size_t smem = sizeof(float) * CAM_DIM * (size_t)D;
  // opt in to more than the default dynamic shared memory (static + dynamic
  // above 48 KB needs it). The attribute belongs to the current device, so
  // it is set on every launch (a cheap host call).
  cudaError_t e = cudaFuncSetAttribute(k1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k1_kernel<<<1, K1_THREADS, smem, (cudaStream_t)stream>>>(
      x, P, xp_org, act_full, act_part, meas, sel, xo, Po, top_idx, top_score, n_visible, pidx,
      pmask, D, MF, NSEL, MAXP, *p);
  return (int)cudaGetLastError();
}

// An empty kernel: its launch time is the floor under every kernel here
// (chip_smoke.py reports it beside the byte/operation bounds).
__global__ void k0_empty() {}

extern "C" int k0_empty_launch(void* stream) {
  k0_empty<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
