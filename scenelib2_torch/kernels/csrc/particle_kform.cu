// K10b: per-particle measurement prediction from K-form inputs.
//
// Replaces scenelib2_tpu/kernels/pallas_particle.py (pallas_particle_predict /
// _predict_kernel, pallas_call at pallas_particle.py:197): for every slot f
// and depth hypothesis lambda, the image point, S^-1, det and the 3-sigma
// half extents of the ray zr + lambda zh, with S = A (K0 + lambda Ksym +
// lambda^2 K2) A' + R. The slot's 33 values (zr, zh, K0, Ksym, K2 row-major)
// are the TPU kernel's SMEM parameter row and particle_chain.cuh's GEOM
// layout, so the tail is particle_chain.cuh::particle_tail, the device code
// K10 and K4 run after their prologue (built with -fmad=false). The plain
// PyTorch twin is scenelib2_torch/kernels/particle.py::particle_predict_kform_plain.
//
// Bound on an H100: a slot's 132 bytes of geometry and lambda in, 8 rows of
// `lanes` floats out, ~90 operations a lane: nanoseconds for the few slots a
// caller passes; the launch dominates. Design: one block of 128 threads per
// slot, the geometry in shared memory, each thread the tail of particles t,
// t + 128, ... of the padded row (lambda = 1 at or beyond NP, as the TPU
// wrapper pads it).
#include <cuda_runtime.h>
#include <math.h>

#include "particle_chain.cuh"

#define K10B_THREADS 128

struct K10bParams {
  int F, NP, lanes;
  ParticleConsts pc;
};

__global__ void __launch_bounds__(K10B_THREADS)
k10b_kernel(const float* __restrict__ par, const float* __restrict__ lam, float* __restrict__ out,
            K10bParams p) {
  __shared__ float geom[GEOM_N];
  const int f = blockIdx.x, t = threadIdx.x;
  if (t < GEOM_N) geom[t] = par[(size_t)f * GEOM_N + t];
  __syncthreads();
  for (int l = t; l < p.lanes; l += K10B_THREADS) {
    float pr[NROWS];
    particle_tail(l < p.NP ? lam[(size_t)f * p.NP + l] : 1.0f, geom, p.pc, pr);
    for (int r = 0; r < NROWS; ++r) out[((size_t)f * NROWS + r) * p.lanes + l] = pr[r];
  }
}

// par [F][33] (zr, zh, K0, Ksym, K2), lam [F][NP] -> out [F][8][lanes]
extern "C" int k10b_particle_kform(const float* par, const float* lam, float* out, const K10bParams* p,
                                   void* stream) {
  if (p->NP > p->lanes || p->lanes % 128 != 0) return (int)cudaErrorInvalidValue;
  if (p->F == 0) return 0;
  k10b_kernel<<<p->F, K10B_THREADS, 0, (cudaStream_t)stream>>>(par, lam, out, *p);
  return (int)cudaGetLastError();
}
