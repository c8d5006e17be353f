// K10: per-particle measurement prediction of every (lane, partial slot).
//
// Replaces scenelib2_tpu/kernels/pallas_particle.py
// (pallas_particle_predict_fused / _predict_geom_kernel). The plain PyTorch
// twin is scenelib2_torch/kernels/particle.py::particle_predict_plain; the
// chain is particle_chain.cuh, the device code K4 runs in its prologue, so
// these rows equal K4's for the same slot (built with -fmad=false).
//
// Bound on an H100 at 64 lanes x 1 slot: ~0.3 MB in and out and ~0.7 MFLOP,
// well under a microsecond; the launch dominates. Design: one block of 128
// threads per (lane, slot); the block runs the slot geometry prologue into
// shared memory; thread t runs the per-particle tail of particles t, t + 128,
// ... (lanes at or beyond NP at lambda = 1, as the TPU wrapper pads them) and
// writes their columns of the [8, lanes] rows, lanes = max(128, NP rounded up
// to 128).
#include <cuda_runtime.h>
#include <math.h>

#include "particle_chain.cuh"

#define K10_THREADS 128
#define NSHARED 56
#define NSLOT 84

struct K10Params {
  int n_lanes, F, NP, lanes;
  ParticleConsts pc;
};

__global__ void __launch_bounds__(K10_THREADS)
k10_kernel(const float* __restrict__ shared_rows, const float* __restrict__ slot_rows,
           const float* __restrict__ lam, float* __restrict__ out, K10Params p) {
  __shared__ float geom[GEOM_N];
  __shared__ float scratch[PROLOGUE_SCRATCH];
  const int bf = blockIdx.x;  // lane * F + slot
  const int lane = bf / p.F;
  const int t = threadIdx.x;
  geometry_prologue(shared_rows + (size_t)lane * NSHARED, slot_rows + (size_t)bf * NSLOT, geom, scratch, t,
                    K10_THREADS);
  __syncthreads();
  for (int l = t; l < p.lanes; l += K10_THREADS) {
    float pr[NROWS];
    particle_tail(l < p.NP ? lam[(size_t)bf * p.NP + l] : 1.0f, geom, p.pc, pr);
    for (int r = 0; r < NROWS; ++r) out[((size_t)bf * NROWS + r) * p.lanes + l] = pr[r];
  }
}

extern "C" int k10_particle_predict(const float* shared_rows, const float* slot_rows, const float* lam,
                                    float* out, const K10Params* p, void* stream) {
  if (p->NP > p->lanes || p->lanes % 128 != 0) return (int)cudaErrorInvalidValue;
  const int blocks = p->n_lanes * p->F;
  if (blocks == 0) return 0;
  k10_kernel<<<blocks, K10_THREADS, 0, (cudaStream_t)stream>>>(shared_rows, slot_rows, lam, out, *p);
  return (int)cudaGetLastError();
}
