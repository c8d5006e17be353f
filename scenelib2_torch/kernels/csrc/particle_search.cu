// K13: the particle-cloud search over precomputed score maps.
//
// Replaces scenelib2_tpu/kernels/pallas_particle_search.py
// (pallas_multi_ellipse_search / _kernel, pallas_call at
// pallas_particle_search.py:206), the batch route with
// SCENELIB2_BATCH_SB=0 (reference SearchMultipleOverlappingEllipses,
// search_multiple_overlapping_ellipses.cpp:106-196). For every particle of
// every (lane, slot): over its effective region [v_lo, v_hi) x [u_lo, u_hi)
// (its clamped search window cut to its ellipse's 3-sigma box; the wrapper
// computes the region in int32 as the TPU wrapper does), the cells inside the
// ellipse ((a urel) urel + ((2b) urel) vrel + (c vrel) vrel < no_sigma^2, the
// TPU kernel's operation order, built with -fmad=false); the minimum of the
// map there against the 1e6 of a masked cell, and among the cells at the
// minimum the largest key u*H + v; a NaN in the region makes the minimum NaN
// and leaves no key (jnp.min propagates NaN). A particle that is not alive
// gets (1e6, -1). The plain PyTorch twin is
// scenelib2_torch/kernels/particle_search.py::particle_search_plain.
//
// The TPU kernel scans an (8, 128)-aligned block around each region, picked
// by a ladder of block sizes, a vector-memory economy with the same result
// (the block covers the region, the mask is the region's, and the minimum and
// the last-tie key are order-free); here only the region is read.
//
// Bound on an H100 at 64 lanes x 100 particles: the cells of the regions read
// once (at most 64 x 100 x 65 x 65 x 4 B = 108 MB if every region were a whole
// window; converged clouds read a few KB each) and ~10 operations a cell:
// on the replay's data a few microseconds at the memory rate. Design: one
// block per (lane, slot), one warp per particle; the lanes stride over the
// particle's region, reading the map from global memory (the regions of a
// cloud overlap, so L1 / L2 serve most reads), then one warp reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K13_THREADS 256
#define K13_MISS 1e6f

struct K13Params {
  int H, W, P;
  float no_sigma2;
};

// int32 subtraction with two's-complement wrap-around, as XLA's
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// (value, key) order of the search: the smaller value, then the larger key
__device__ __forceinline__ bool beats(float v, int k, float bv, int bk) {
  return v < bv || (v == bv && k > bk);
}

// maps [N][H][W]; geo [N][P][7] int32: uc, vc, v_lo, v_hi, u_lo, u_hi, alive;
// abc [N][P][3] f32: the S^-1 entries a, b, c; best [N][P], key [N][P]
__global__ void __launch_bounds__(K13_THREADS)
k13_kernel(const float* __restrict__ maps, const int* __restrict__ geo, const float* __restrict__ abc,
           float* __restrict__ best_o, int* __restrict__ key_o, K13Params p) {
  const int blk = blockIdx.x;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int n_warps = blockDim.x >> 5;
  const float* __restrict__ map = maps + (size_t)blk * p.H * p.W;
  for (int q = warp; q < p.P; q += n_warps) {
    const int* g = geo + ((size_t)blk * p.P + q) * 7;
    const int uc = g[0], vc = g[1], v_lo = g[2], v_hi = g[3], u_lo = g[4], u_hi = g[5];
    const bool alive = g[6] != 0;
    const float* s = abc + ((size_t)blk * p.P + q) * 3;
    const float a = s[0], b2 = 2.0f * s[1], c = s[2];
    float best = K13_MISS;
    int key = -1;
    bool nan = false;
    if (alive && v_hi > v_lo && u_hi > u_lo) {
      const int ncol = u_hi - u_lo;
      const int ncell = (v_hi - v_lo) * ncol;
      for (int e = wl; e < ncell; e += 32) {
        const int v = v_lo + e / ncol, u = u_lo + e % ncol;
        const float urel = (float)wrap_sub(u, uc), vrel = (float)wrap_sub(v, vc);
        const float t1 = (a * urel) * urel;
        const float t2 = (b2 * urel) * vrel;
        const float t3 = (c * vrel) * vrel;
        if (!(((t1 + t2) + t3) < p.no_sigma2)) continue;
        const float val = map[(size_t)v * p.W + u];
        const int k = u * p.H + v;
        if (val != val)
          nan = true;
        else if (beats(val, k, best, key)) {
          best = val;
          key = k;
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const int ok = __shfl_xor_sync(0xffffffffu, key, o);
      if (beats(ov, ok, best, key)) {
        best = ov;
        key = ok;
      }
    }
    nan = __any_sync(0xffffffffu, nan);
    if (wl == 0) {
      best_o[(size_t)blk * p.P + q] = nan ? nanf("") : best;
      key_o[(size_t)blk * p.P + q] = nan ? -1 : key;
    }
  }
}

extern "C" int k13_particle_search(const float* maps, const int* geo, const float* abc, float* best,
                                   int* key, int n_blocks, const K13Params* p, void* stream) {
  if (p->P < 0 || (size_t)p->W * p->H >= (1u << 31)) return (int)cudaErrorInvalidValue;
  if (n_blocks == 0 || p->P == 0) return 0;
  k13_kernel<<<n_blocks, K13_THREADS, 0, (cudaStream_t)stream>>>(maps, geo, abc, best, key, *p);
  return (int)cudaGetLastError();
}
