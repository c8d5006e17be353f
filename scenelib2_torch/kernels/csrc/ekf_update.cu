// K3: fused joint EKF update + quaternion-norm transform + feature bookkeeping
//     + delete + symmetrize.
//
// Replaces scenelib2_tpu/kernels/pallas_ekf.py
// (pallas_joint_update_norm_compact / _update_kernel_compact, with
// pallas_linalg.py::chol_linv_body). The plain PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::joint_update_plain; every sum runs
// in the same order there and here (built with -fmad=false). The update from
// S on (L^-1, S^-1, W, x', P', the quaternion-norm transform) is
// update_tail.cuh, which K15 (ekf_update_dense.cu) runs too.
//
// Bound on an H100: ~0.1 MB of P in and out and ~1 MFLOP at D=109, M=20, far
// below a microsecond; the launch and the M sequential factorisation steps
// dominate. Design: ONE block of 256 threads. H is never formed: each of its
// rows has 10 non-zeros, read from K1's selected columns. P H', W and W S
// (D x M) and the M x M matrices live in shared memory; P' is built in the
// output buffer; each Cholesky / substitution step is one block-wide pass
// between barriers. Labels are ranked as int32 (the TPU kernel ranked them
// as f32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "update_tail.cuh"

#define CAM_DIM 13
#define SLOT_DIM 6
#define MAX_M 64
#define MAX_MF 256
#define K3_THREADS 256

// measure.py row layout
#define O_H 0
#define O_HX 2
#define O_HY 16
#define O_RD 22

struct K3Params {
  float min_attempts, success_fraction;
};

__global__ void __launch_bounds__(K3_THREADS)
k3_kernel(const float* __restrict__ x, const float* __restrict__ P, const float* __restrict__ sel,
          const float* __restrict__ z, const uint8_t* __restrict__ succ,
          const int* __restrict__ offs, const int* __restrict__ attempts,
          const int* __restrict__ successes, const uint8_t* __restrict__ sched,
          const uint8_t* __restrict__ active, const int* __restrict__ label,
          const uint8_t* __restrict__ sel_mask, const int* __restrict__ top_idx,
          float* __restrict__ xo, float* __restrict__ Po, int* __restrict__ att_o,
          int* __restrict__ suc_o, uint8_t* __restrict__ sch_o, uint8_t* __restrict__ kill_o,
          int D, int NSEL, int MF, K3Params p) {
  extern __shared__ float dyn[];
  const int M = 2 * NSEL;
  float* PHt = dyn;              // [D][M]
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
  __shared__ float hx[MAX_M][7], hy[MAX_M][3], nu[MAX_M], rd[MAX_M];
  __shared__ int offm[MAX_M];
  __shared__ int any_s;
  __shared__ int att_s[MAX_MF], suc_s[MAX_MF], order_s[MAX_MF];
  __shared__ uint8_t sch1_s[MAX_MF], kill_s[MAX_MF];
  const int tid = threadIdx.x, nt = blockDim.x;

  // ---- H, nu, R from the selected columns (failed rows: H=0, nu=0, R=1)
  if (tid < M) {
    const int k = tid >> 1, i = tid & 1;
    const float sf = succ[k] ? 1.0f : 0.0f;
    for (int a = 0; a < 7; ++a) hx[tid][a] = sel[(O_HX + 7 * i + a) * NSEL + k] * sf;
    for (int j = 0; j < 3; ++j) hy[tid][j] = sel[(O_HY + 3 * i + j) * NSEL + k] * sf;
    nu[tid] = sf * (z[2 * k + i] - sel[(O_H + i) * NSEL + k]);
    rd[tid] = succ[k] ? sel[O_RD * NSEL + k] : 1.0f;
    offm[tid] = offs[k];
  }
  if (tid == 0) {
    int a = 0;
    for (int k = 0; k < NSEL; ++k) a |= succ[k] != 0;
    any_s = a;
  }
  __syncthreads();
  const bool any = any_s != 0;

  if (any) {
    // ---- P H' (state dims ascending over H's non-zeros)
    for (int e = tid; e < D * M; e += nt) {
      const int d = e / M, m = e - d * M;
      const float* Pr = P + (size_t)d * D;
      float acc = Pr[0] * hx[m][0];
      for (int a = 1; a < 7; ++a) acc = acc + Pr[a] * hx[m][a];
      for (int j = 0; j < 3; ++j) acc = acc + Pr[offm[m] + j] * hy[m][j];
      PHt[e] = acc;
    }
    __syncthreads();
    // ---- S = H P H' + R
    for (int e = tid; e < M * M; e += nt) {
      const int m = e / M, n = e - m * M;
      float acc = hx[m][0] * PHt[n];
      for (int a = 1; a < 7; ++a) acc = acc + hx[m][a] * PHt[a * M + n];
      for (int j = 0; j < 3; ++j) acc = acc + hy[m][j] * PHt[(offm[m] + j) * M + n];
      S[e] = acc + (m == n ? rd[m] : 0.0f);
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

  // ---- bookkeeping (monoslam.cpp:644-703)
  for (int i = tid; i < MF; i += nt) {
    int att = attempts[i], suc = successes[i];
    for (int k = 0; k < NSEL; ++k)
      if (top_idx[k] == i) {
        att += sel_mask[k] ? 1 : 0;
        suc += succ[k] ? 1 : 0;
      }
    const float fatt = (float)att;
    const float ratio = att > 0 ? (float)suc / fmaxf(fatt, 1.0f) : 1.0f;
    const bool act = active[i] != 0;
    const bool bad = act && fatt >= p.min_attempts && ratio < p.success_fraction;
    att_s[i] = att;
    suc_s[i] = suc;
    sch1_s[i] = ((sched[i] != 0) || bad) && act;
    // list position: stable rank of (label if active else 2^30, slot)
    const int key = act ? label[i] : (1 << 30);
    int rank = 0;
    for (int j = 0; j < MF; ++j) {
      const int kj = active[j] ? label[j] : (1 << 30);
      rank += (kj < key) || (kj == key && j < i);
    }
    order_s[rank] = i;
  }
  __syncthreads();
  // within each run of consecutively scheduled list positions, even run
  // offsets die this frame (the exterminate iterator skip)
  for (int pos = tid; pos < MF; pos += nt) {
    int run_start = 0;
    for (int q2 = 0; q2 <= pos; ++q2) {
      const int t = sch1_s[order_s[q2]] ? 0 : q2 + 1;
      run_start = t > run_start ? t : run_start;
    }
    const int slot = order_s[pos];
    kill_s[slot] = sch1_s[slot] && ((pos - run_start) % 2 == 0);
  }
  __syncthreads();
  for (int i = tid; i < MF; i += nt) {
    att_o[i] = att_s[i];
    suc_o[i] = suc_s[i];
    sch_o[i] = sch1_s[i] && !kill_s[i];
    kill_o[i] = kill_s[i];
  }

  // ---- zero the killed slots, then P = P/2 + P'/2
  for (int d = tid; d < D; d += nt) {
    const float keep = d < CAM_DIM ? 1.0f : (kill_s[(d - CAM_DIM) / SLOT_DIM] ? 0.0f : 1.0f);
    xo[d] = xu[d] * keep;
  }
  __syncthreads();
  for (int e = tid; e < D * D; e += nt) {
    const int i = e / D, j = e - i * D;
    if (i > j) continue;
    const float ki = i < CAM_DIM ? 1.0f : (kill_s[(i - CAM_DIM) / SLOT_DIM] ? 0.0f : 1.0f);
    const float kj = j < CAM_DIM ? 1.0f : (kill_s[(j - CAM_DIM) / SLOT_DIM] ? 0.0f : 1.0f);
    const float k2 = ki * kj;
    const float a = Po[(size_t)i * D + j] * k2;
    const float b = Po[(size_t)j * D + i] * k2;
    const float v = a * 0.5f + b * 0.5f;
    Po[(size_t)i * D + j] = v;
    Po[(size_t)j * D + i] = b * 0.5f + a * 0.5f;
  }
}

extern "C" int k3_joint_update(const float* x, const float* P, const float* sel, const float* z,
                               const uint8_t* succ, const int* offs, const int* attempts,
                               const int* successes, const uint8_t* sched, const uint8_t* active,
                               const int* label, const uint8_t* sel_mask, const int* top_idx,
                               float* xo, float* Po, int* att_o, int* suc_o, uint8_t* sch_o,
                               uint8_t* kill_o, int D, int NSEL, int MF, const K3Params* p,
                               void* stream) {
  const int M = 2 * NSEL;
  if (M > MAX_M || MF > MAX_MF) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * ((size_t)3 * D * M + 8 * (size_t)D + D + 5 * (size_t)M * M);
  // opt in to more than the default dynamic shared memory (static + dynamic
  // above 48 KB needs it). The attribute belongs to the current device, so
  // it is set on every launch (a cheap host call).
  cudaError_t e = cudaFuncSetAttribute(k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k3_kernel<<<1, K3_THREADS, smem, (cudaStream_t)stream>>>(
      x, P, sel, z, succ, offs, attempts, successes, sched, active, label, sel_mask, top_idx, xo, Po,
      att_o, suc_o, sch_o, kill_o, D, NSEL, MF, *p);
  return (int)cudaGetLastError();
}
