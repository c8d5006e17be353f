// K7: per-slot measurement prediction for every lane of the batch step.
//
// Replaces scenelib2_tpu/kernels/pallas_measure.py (pallas_measure_predict /
// _measure_kernel -> _measure_math). The plain PyTorch twin is
// scenelib2_torch/kernels/measure.py::measure_predict_plain; the chain itself
// is measure_chain.cuh, shared with K1 (built with -fmad=false, the same
// operations in the same order). Unlike K1, the state is already predicted,
// the score row keeps -inf where a slot is not visible, and the selection is
// made outside the kernel.
//
// Bound on an H100 at 64 lanes x 16 slots: ~0.4 MB in and out and
// ~0.6 MFLOP, well under a microsecond; the launch dominates. Design: one
// thread per (lane, slot); a block holds K7_THREADS slots of the flattened
// lane x slot range, so one launch serves every lane.
#include <cuda_runtime.h>
#include <stdint.h>

#include "measure_chain.cuh"

#define K7_THREADS 128

__global__ void __launch_bounds__(K7_THREADS)
k7_kernel(const float* __restrict__ xp, const float* __restrict__ pxx7,
          const float* __restrict__ ys3, const float* __restrict__ xp_org,
          const float* __restrict__ pxy, const float* __restrict__ pyy,
          const uint8_t* __restrict__ act_full, float* __restrict__ out, int B, int MF,
          MeasConsts c) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= B * MF) return;
  const int lane = e / MF, slot = e - lane * MF;
  float r[3], q[4], pxx[7][7], y[3], xpo[7], pxy_s[7][3], pyy_s[3][3], m[NOUT];
  for (int i = 0; i < 3; ++i) r[i] = xp[lane * 7 + i];
  for (int i = 0; i < 4; ++i) q[i] = xp[lane * 7 + 3 + i];
  for (int i = 0; i < 7; ++i)
    for (int j = 0; j < 7; ++j) pxx[i][j] = pxx7[lane * 49 + 7 * i + j];
  for (int j = 0; j < 3; ++j) y[j] = ys3[e * 3 + j];
  for (int j = 0; j < 7; ++j) xpo[j] = xp_org[e * 7 + j];
  for (int a = 0; a < 7; ++a)
    for (int j = 0; j < 3; ++j) pxy_s[a][j] = pxy[e * 21 + 3 * a + j];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) pyy_s[i][j] = pyy[e * 9 + 3 * i + j];
  measure_lane(r, q, pxx, y, xpo, pxy_s, pyy_s, act_full[e] != 0, c, m);
  for (int k = 0; k < NOUT; ++k) out[(lane * NOUT + k) * MF + slot] = m[k];
}

extern "C" int k7_measure(const float* xp, const float* pxx7, const float* ys3, const float* xp_org,
                          const float* pxy, const float* pyy, const uint8_t* act_full, float* out,
                          int B, int MF, const MeasConsts* c, void* stream) {
  if (B * MF == 0) return 0;
  const int blocks = (B * MF + K7_THREADS - 1) / K7_THREADS;
  k7_kernel<<<blocks, K7_THREADS, 0, (cudaStream_t)stream>>>(xp, pxx7, ys3, xp_org, pxy, pyy,
                                                             act_full, out, B, MF, *c);
  return (int)cudaGetLastError();
}
