// K16: the multi-ellipse search of a particle cloud over one score map per
// slot.
//
// Replaces scenelib2_tpu/kernels/pallas_search.py
// (pallas_multi_ellipse_search / _particle_kernel, pallas_call at
// pallas_search.py:618, kernel :491-562). For every particle (reference
// SearchMultipleOverlappingEllipses, search_multiple_overlapping_ellipses.cpp:
// 106-196): uc, vc converted to int32 as XLA converts (NaN -> 0,
// saturation); the half-extents floor(no_sigma / sqrt(a - b^2 / c)) and
// floor(no_sigma / sqrt(c - b^2 / a)) kept in f32; the window of side_u x
// side_v at u0 = clip(uc - side_u / 2, 0, W - side_u) (int32 wrapping), v0
// alike; the TPU kernel's aligned band (rows [va, va + band_v), columns
// [ua, ua + 256)); over the window's cells inside the band with u < W, the
// box |u - uc| <= hw, |v - vc| <= hh (f32) and the ellipse (a urel) urel +
// ((2b) urel) vrel + (c vrel) vrel < no_sigma^2 (the TPU kernel's order,
// built with -fmad=false): the minimum against the 1e6 of the band's other
// cells and the largest key u*H + v at the minimum; a NaN there makes the
// minimum NaN and leaves no key (jnp.min propagates NaN). Every particle is
// searched, alive or not; overflow = a half-extent above side / 2. The plain
// PyTorch twin is scenelib2_torch/kernels/multi_ellipse.py::
// multi_ellipse_search_plain.
//
// Bound on an H100: the map cells under each slot's windows read once and
// ~12 operations per cell of each particle's window: microseconds at most.
// Design: one warp per particle, K16_WARPS particles a block, a grid of
// (slot, particle group); the lanes stride over the window-in-band cells,
// reading the map from global memory (the windows of a cloud overlap, so
// L1 / L2 serve most reads), then one warp reduction.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K16_WARPS 8
#define K16_MISS 1e6f

struct K16Params {
  int H, W, P, side_u, side_v, pad_h, pad_w, band_v;
  float no_sigma, no_sigma2;
};

// float to int32 as XLA converts: NaN -> 0, saturation at the int32 range
__device__ __forceinline__ int xla_f2i(float v) {
  if (v != v) return 0;
  if (v >= 2147483648.0f) return 2147483647;
  if (v < -2147483648.0f) return -2147483647 - 1;
  return (int)v;
}

// int32 subtraction with two's-complement wrap-around, as XLA's
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// (value, key) order of the search: the smaller value, then the larger key
__device__ __forceinline__ bool beats(float v, int k, float bv, int bk) {
  return v < bv || (v == bv && k > bk);
}

// maps [F][H][W]; rows [F][P][6] f32: trunc(u), trunc(v), a, b, c, alive;
// best [F][P], key [F][P], over [F][P]
__global__ void __launch_bounds__(K16_WARPS * 32)
k16_kernel(const float* __restrict__ maps, const float* __restrict__ rows, float* __restrict__ best_o,
           int* __restrict__ key_o, uint8_t* __restrict__ over_o, K16Params p) {
  const int f = blockIdx.x;
  const int q = blockIdx.y * K16_WARPS + (threadIdx.x >> 5);
  const int wl = threadIdx.x & 31;
  if (q >= p.P) return;
  const float* __restrict__ map = maps + (size_t)f * p.H * p.W;
  const float* r = rows + ((size_t)f * p.P + q) * 6;
  const int uc = xla_f2i(r[0]), vc = xla_f2i(r[1]);
  const float a = r[2], b = r[3], c = r[4];
  const float hw = floorf(p.no_sigma / sqrtf(a - b * b / c));
  const float hh = floorf(p.no_sigma / sqrtf(c - b * b / a));
  const int R_u = p.side_u / 2, R_v = p.side_v / 2;
  const int u0 = min(max(wrap_sub(uc, R_u), 0), p.W - p.side_u);
  const int v0 = min(max(wrap_sub(vc, R_v), 0), p.H - p.side_v);
  const int va = min(v0 / 8 * 8, p.pad_h - p.band_v);
  const int ua = min(u0 / 128 * 128, p.pad_w - 256);
  const int r0 = max(v0, va), r1 = min(v0 + p.side_v, va + p.band_v);
  const int c0 = max(u0, ua), c1 = min(min(u0 + p.side_u, ua + 256), p.W);
  const float b2 = 2.0f * b;
  float best = K16_MISS;
  int key = -1;
  bool nan = false;
  if (r1 > r0 && c1 > c0) {
    const int ncol = c1 - c0;
    const int ncell = (r1 - r0) * ncol;
    for (int e = wl; e < ncell; e += 32) {
      const int v = r0 + e / ncol, u = c0 + e % ncol;
      const float urel = (float)wrap_sub(u, uc), vrel = (float)wrap_sub(v, vc);
      if (!(fabsf(urel) <= hw && fabsf(vrel) <= hh)) continue;
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
    best_o[(size_t)f * p.P + q] = nan ? nanf("") : best;
    key_o[(size_t)f * p.P + q] = nan ? -1 : key;
    over_o[(size_t)f * p.P + q] = hw > (float)R_u || hh > (float)R_v;
  }
}

extern "C" int k16_multi_ellipse(const float* maps, const float* rows, float* best, int* key, uint8_t* over,
                                 int F, const K16Params* p, void* stream) {
  if (p->P < 0 || (size_t)p->W * p->H >= (1u << 31) || p->side_u > p->W || p->side_v > p->H ||
      p->band_v > p->pad_h || p->pad_w < 256)
    return (int)cudaErrorInvalidValue;
  if (F == 0 || p->P == 0) return 0;
  const dim3 grid(F, (p->P + K16_WARPS - 1) / K16_WARPS);
  k16_kernel<<<grid, K16_WARPS * 32, 0, (cudaStream_t)stream>>>(maps, rows, best, key, over, *p);
  return (int)cudaGetLastError();
}
