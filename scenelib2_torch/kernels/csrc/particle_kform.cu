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
// Bound on an H100: a slot's 132 bytes of geometry and NP depths in, 8 rows
// of `lanes` floats out (1 MB at 2 slots x 16,384 particles: ~0.3 us at
// 3.35 TB/s), ~90 operations a lane; below ~10^5 particles the launch
// dominates. Design: a 2-D grid of (slot, block of K10B_THREADS lanes), one
// particle a thread; each CTA stages its slot's geometry in shared memory
// once (the depth's load issued first) and each warp stores a row's 32
// consecutive lanes as one 128-byte transaction. Two particles a thread
// (their tails interleaved, 8-byte stores) cost ~0.6 us more at every size
// up to one wave of resident CTAs on an H100 and saved ~1% past it, and four
// (16-byte stores) spilled: neither is kept.
// Lambda is 1 at or beyond NP, as the TPU wrapper pads it.
#include <cuda_runtime.h>
#include <math.h>

#include "particle_chain.cuh"

#define K10B_THREADS 128

struct K10bParams {
  int F, NP, lanes;
  ParticleConsts pc;
};

// CTA (f, b): slot f, lanes [b K10B_THREADS, (b + 1) K10B_THREADS); lanes is
// a multiple of K10B_THREADS, so every thread has a lane
__global__ void __launch_bounds__(K10B_THREADS)
k10b_kernel(const float* __restrict__ par, const float* __restrict__ lam, float* __restrict__ out,
            K10bParams p) {
  __shared__ float geom[GEOM_N];
  const int f = blockIdx.x, t = threadIdx.x;
  const int l = blockIdx.y * K10B_THREADS + t;
  // the depth's load is issued before the geometry's, so that the two trips
  // to device memory overlap
  const float lv = l < p.NP ? lam[(size_t)f * p.NP + l] : 1.0f;
  if (t < GEOM_N) geom[t] = par[(size_t)f * GEOM_N + t];
  __syncthreads();
  float pr[NROWS];
  particle_tail(lv, geom, p.pc, pr);
  float* o = out + (size_t)f * NROWS * p.lanes + l;
#pragma unroll
  for (int r = 0; r < NROWS; ++r) o[(size_t)r * p.lanes] = pr[r];
}

// par [F][33] (zr, zh, K0, Ksym, K2), lam [F][NP] -> out [F][8][lanes]
extern "C" int k10b_particle_kform(const float* par, const float* lam, float* out, const K10bParams* p,
                                   void* stream) {
  if (p->NP > p->lanes || p->lanes % K10B_THREADS != 0) return (int)cudaErrorInvalidValue;
  if (p->F == 0) return 0;
  const int blocks = p->lanes / K10B_THREADS;
  if (blocks > 65535) return (int)cudaErrorInvalidValue;
  k10b_kernel<<<dim3((unsigned)p->F, (unsigned)blocks), K10B_THREADS, 0, (cudaStream_t)stream>>>(par, lam, out,
                                                                                                   *p);
  return (int)cudaGetLastError();
}
