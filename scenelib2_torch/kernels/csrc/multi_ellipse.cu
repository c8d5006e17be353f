// K16: the multi-ellipse search of a particle cloud over one score map per
// slot.
//
// Replaces scenelib2_tpu/kernels/pallas_search.py
// (pallas_multi_ellipse_search / _particle_kernel, pallas_call at
// pallas_search.py:618, kernel :491-562, with its wrapper's per-particle
// rows at :600-611). For every particle (reference
// SearchMultipleOverlappingEllipses, search_multiple_overlapping_ellipses.cpp:
// 106-196), as multi_ellipse.py::multi_ellipse_search_plain computes it:
// uc, vc = trunc(h) converted to int32 as XLA converts (NaN -> 0,
// saturation: __float2int_rz, cvt.rzi.s32.f32); the half-extents hw =
// floor(no_sigma / sqrt(a - (b b) / c)) and hh = floor(no_sigma / sqrt(c -
// (b b) / a)) kept in f32; the window of side_u x side_v at u0 = clip(uc -
// side_u / 2, 0, W - side_u) (int32 wrapping), v0 alike; the TPU kernel's
// aligned band (rows [va, va + band_v), columns [ua, ua + 256)); over the
// window's cells inside the band with u < W, the box |u - uc| <= hw,
// |v - vc| <= hh (the int32-wrapped offsets as f32, compared in f32) and the
// ellipse (a urel) urel + ((2b) urel) vrel + (c vrel) vrel < no_sigma^2
// (the TPU kernel's order, built with -fmad=false): the minimum against the
// 1e6 of the band's other cells (a cell at exactly 1e6 ties with it and
// keeps its key) and the largest key u*H + v at the minimum; an admitted
// NaN makes the minimum NaN and leaves no key (jnp.min propagates NaN).
// Every particle is searched, alive or not; found = alive & best <=
// corr_thresh2, (u, v) = (floor(key / H), key mod H) (key -1: (-1, H - 1)),
// overflow = alive & a half-extent above side / 2.
//
// Bound on an H100 (multi_ellipse.py::bytes_and_flops): the map cells under
// each slot's searched rectangles read once and ~12 operations per cell of
// each particle's rectangle: microseconds at most; the launch and one chain
// of dependent loads a particle set the time. Design (K13's,
// particle_search.cu, with K16's rules):
//   - the wrapper launches once with the inputs as they are; the kernel
//     computes each particle's geometry (k16_geom) and writes found, u, v
//     and overflow;
//   - p.cluster CTAs a slot (multi_ellipse.py::ctas_a_slot: up to two a
//     SM, 4 over 64 slots, 8 over 16) of p.threads threads
//     (multi_ellipse.py::THREADS, 512), each a share of the particles
//     (interleaved: rank, rank + cluster, ...), a warp a particle; they
//     share nothing, so they are a plain grid;
//   - a particle walks the rectangle where its window, the band and u < W
//     meet, cut by its box only where the cut is exact (k16_cut: every
//     offset of the rectangle from the centre an int32 without wrap-around
//     and exact in f32); every cell keeps the box and ellipse tests, so the
//     rectangle need only hold every admitted cell;
//   - each CTA stages the read box (the bounding box of every particle's
//     rectangle, dead particles' included) of the slot's map in shared
//     memory where it fits (p.stage floats), else the searches read the map
//     in place;
//   - a warp walks its rectangle row by row with no division (lane l from
//     cell l, 32 cells a step, one carry; K16_UNROLL steps an iteration,
//     their loads in flight together), each admitted cell one 64-bit key
//     (nssd.cuh::score_key: the least value, then the largest u*H + v), one
//     unsigned minimum and a NaN flag over the warp; lane 0 writes the
//     results.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dyn_smem.cuh"
#include "nssd.cuh"

#define K16_MAX_THREADS 1024
#define K16_MAX_CLUSTER 8
#define K16_STAGE_MAX 16384  // floats of the stage at most (64 KB)
#define K16_LOADS 8          // loads in flight a thread while the read box is staged
#define K16_UNROLL 4         // steps of 32 cells a search iteration
#define K16_EXACT 16777216   // 2^24: an int32 offset of at most this magnitude is exact in f32
#define K16_MISS 1e6f
#define K16_NONE 0xFFFFFFFFFFFFFFFFull  // the key of no admitted cell

struct K16Params {
  int H, W, P, side_u, side_v, pad_h, pad_w, band_v;
  int threads;  // a CTA's
  int cluster;  // CTAs a slot
  int stage;    // floats of the stage (set at launch)
  float no_sigma, no_sigma2, corr_thresh2;
};

// int32 subtraction with two's-complement wrap-around, as XLA's
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// [*lo, *hi) cut to the cells whose offset d from the centre passes |f32(d)|
// <= half, where that is exact: every d of the range is an int32 of at most
// 2^24 in magnitude (no wrap-around, exact in f32) and half (an integer
// value or +inf) is below 2^24. A NaN or negative half admits no cell.
// Elsewhere the range stays whole (a superset: each cell is still tested).
__device__ __forceinline__ void k16_cut(int* lo, int* hi, int centre, float half) {
  if (*hi <= *lo) return;
  if (!(half >= 0.0f)) {
    *hi = *lo;
    return;
  }
  const long long dlo = (long long)*lo - centre, dhi = (long long)*hi - 1 - centre;
  if (dlo < -K16_EXACT || dhi > K16_EXACT || half >= (float)K16_EXACT) return;
  const long long h = (long long)half;
  const long long a = max((long long)*lo, (long long)centre - h);
  const long long b = min((long long)*hi, (long long)centre + h + 1);
  *lo = (int)a;
  *hi = (int)(b > a ? b : a);
}

// one particle's geometry: the centre, the walked rectangle [r0, r1) x
// [c0, c1), a, 2b, c and the half-extents
struct K16Geom {
  int uc, vc, r0, r1, c0, c1;
  float a, b2, c, hw, hh;
};

__device__ __forceinline__ K16Geom k16_geom(const float* __restrict__ hc, const float* __restrict__ sinv, int q,
                                            const K16Params& p) {
  K16Geom g;
  g.uc = __float2int_rz(truncf(hc[2 * q]));
  g.vc = __float2int_rz(truncf(hc[2 * q + 1]));
  const float a = sinv[4 * q], b = sinv[4 * q + 1], c = sinv[4 * q + 3];
  g.hw = floorf(p.no_sigma / sqrtf(a - (b * b) / c));
  g.hh = floorf(p.no_sigma / sqrtf(c - (b * b) / a));
  const int u0 = min(max(wrap_sub(g.uc, p.side_u / 2), 0), p.W - p.side_u);
  const int v0 = min(max(wrap_sub(g.vc, p.side_v / 2), 0), p.H - p.side_v);
  const int va = min(v0 / 8 * 8, p.pad_h - p.band_v);
  const int ua = min(u0 / 128 * 128, p.pad_w - 256);
  g.r0 = max(v0, va);
  g.r1 = min(v0 + p.side_v, va + p.band_v);
  g.c0 = max(u0, ua);
  g.c1 = min(min(u0 + p.side_u, ua + 256), p.W);
  k16_cut(&g.c0, &g.c1, g.uc, g.hw);
  k16_cut(&g.r0, &g.r1, g.vc, g.hh);
  g.a = a;
  g.b2 = 2.0f * b;
  g.c = c;
  return g;
}

// The searches of particles q0, q0 + stride, ..., a warp a particle, its
// rectangle walked row by row (see the header). at(v, u): the map's value at
// a cell of the read box (a lane past the rectangle reads its first cell and
// admits nothing).
template <typename At>
__device__ __forceinline__ void k16_search(const float* __restrict__ hc, const float* __restrict__ sinv,
                                           const uint8_t* __restrict__ alive_p, int blk, int q0, int stride,
                                           const K16Params& p, uint8_t* __restrict__ found_o,
                                           int* __restrict__ u_o, int* __restrict__ v_o,
                                           uint8_t* __restrict__ over_o, At at) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int H = p.H;
  for (int q = q0 + stride * warp; q < p.P; q += stride * nw) {
    const K16Geom g = k16_geom(hc, sinv, q, p);
    const bool some = g.c1 > g.c0 && g.r1 > g.r0;
    const int ncol = some ? g.c1 - g.c0 : 0;
    const int ncell = some ? (g.r1 - g.r0) * ncol : 0;
    unsigned long long key = K16_NONE;
    bool nan = false;  // an admitted NaN
    if (ncell > 0) {
      int r = wl / ncol, cc = wl - r * ncol;
      const int dr = 32 / ncol, dc = 32 - dr * ncol;
      for (int e0 = wl; e0 < ncell; e0 += K16_UNROLL * 32) {
#pragma unroll
        for (int j = 0; j < K16_UNROLL; ++j) {
          const bool in = e0 + 32 * j < ncell;
          const int v = g.r0 + r, u = g.c0 + cc;
          const float urel = (float)wrap_sub(u, g.uc), vrel = (float)wrap_sub(v, g.vc);
          const bool box = fabsf(urel) <= g.hw && fabsf(vrel) <= g.hh;
          const float t1 = (g.a * urel) * urel;
          const float t2 = (g.b2 * urel) * vrel;
          const float t3 = (g.c * vrel) * vrel;
          const float val = at(in ? v : g.r0, in ? u : g.c0);
          const bool adm = in && box && ((t1 + t2) + t3) < p.no_sigma2;
          const unsigned long long k = score_key(val, u * H + v);
          nan = nan || (adm && val != val);
          key = (adm && val == val && k < key) ? k : key;
          cc += dc;
          r += dr;
          if (cc >= ncol) {
            cc -= ncol;
            ++r;
          }
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
    nan = __any_sync(0xffffffffu, nan);
    if (wl == 0) {
      const bool alive = alive_p[q] != 0;
      float best = nanf("");
      int kb = -1;
      if (!nan) {
        best = key == K16_NONE ? INFINITY : key_score(key);
        kb = key == K16_NONE ? -1 : key_uv(key);
        // the 1e6 of the band's other cells
        if (!(best <= K16_MISS)) {
          best = K16_MISS;
          kb = -1;
        }
      }
      const size_t o = (size_t)blk * p.P + q;
      found_o[o] = alive && best <= p.corr_thresh2;
      u_o[o] = kb >= 0 ? kb / H : -1;
      v_o[o] = kb >= 0 ? kb % H : H - 1;
      over_o[o] = alive && (g.hw > (float)(p.side_u / 2) || g.hh > (float)(p.side_v / 2));
    }
  }
}

// maps [N][H][W]; h_centres [N][P][2]; sinv [N][P][2][2]; alive [N][P];
// found, u, v, over [N][P]; CTA b serves slot b / p.cluster
__global__ void __launch_bounds__(K16_MAX_THREADS)
k16_kernel(const float* __restrict__ maps, const float* __restrict__ h_centres, const float* __restrict__ sinv,
           const uint8_t* __restrict__ alive, uint8_t* __restrict__ found_o, int* __restrict__ u_o,
           int* __restrict__ v_o, uint8_t* __restrict__ over_o, K16Params p) {
  extern __shared__ float stage[];
  __shared__ int wcell[K16_MAX_THREADS / 32][4];  // the warps' read boxes
  const int t = threadIdx.x, T = blockDim.x, warp = t >> 5, wl = t & 31, nw = T >> 5;
  const int cs = p.cluster, rank = (int)(blockIdx.x % cs), blk = (int)(blockIdx.x / cs);
  const int H = p.H, W = p.W, P = p.P;
  const float* __restrict__ map = maps + (size_t)blk * H * W;
  const float* __restrict__ hc = h_centres + (size_t)blk * P * 2;
  const float* __restrict__ si = sinv + (size_t)blk * P * 4;
  const uint8_t* __restrict__ al = alive + (size_t)blk * P;

  // ---- the read box: the bounding box of every particle's rectangle
  int rd[4];  // [rd0, rd1) x [rd2, rd3); all 0 when no search reads a cell
  {
    int cb[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
    for (int l = t; l < P; l += T) {
      const K16Geom g = k16_geom(hc, si, l, p);
      if (g.r1 <= g.r0 || g.c1 <= g.c0) continue;
      cb[0] = min(cb[0], g.r0);
      cb[1] = max(cb[1], g.r1);
      cb[2] = min(cb[2], g.c0);
      cb[3] = max(cb[3], g.c1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      cb[0] = min(cb[0], __shfl_xor_sync(0xffffffffu, cb[0], o));
      cb[1] = max(cb[1], __shfl_xor_sync(0xffffffffu, cb[1], o));
      cb[2] = min(cb[2], __shfl_xor_sync(0xffffffffu, cb[2], o));
      cb[3] = max(cb[3], __shfl_xor_sync(0xffffffffu, cb[3], o));
    }
    if (wl == 0)
      for (int k = 0; k < 4; ++k) wcell[warp][k] = cb[k];
    __syncthreads();
    for (int w = 0; w < nw; ++w) {
      cb[0] = min(cb[0], wcell[w][0]);
      cb[1] = max(cb[1], wcell[w][1]);
      cb[2] = min(cb[2], wcell[w][2]);
      cb[3] = max(cb[3], wcell[w][3]);
    }
    const bool any = cb[1] > cb[0];
    for (int k = 0; k < 4; ++k) rd[k] = any ? cb[k] : 0;
  }
  const int rh = rd[1] - rd[0], rw = rd[3] - rd[2];

  // ---- the read box staged, K16_LOADS loads in flight a thread
  const bool staged = rh > 0 && rh * rw <= p.stage;
  if (staged) {
    for (int e0 = t; e0 < rh * rw; e0 += K16_LOADS * T) {
      float x[K16_LOADS];
#pragma unroll
      for (int j = 0; j < K16_LOADS; ++j) {
        const int e = min(e0 + j * T, rh * rw - 1), r = e / rw;
        x[j] = __ldg(map + (size_t)(rd[0] + r) * W + rd[2] + (e - r * rw));
      }
#pragma unroll
      for (int j = 0; j < K16_LOADS; ++j)
        if (e0 + j * T < rh * rw) stage[e0 + j * T] = x[j];
    }
    __syncthreads();
  }

  // ---- this CTA's particles, a warp a particle
  if (staged) {
    const float* st = stage;
    const int v0 = rd[0], u0 = rd[2];
    k16_search(hc, si, al, blk, rank, cs, p, found_o, u_o, v_o, over_o,
               [=](int v, int u) { return st[(v - v0) * rw + (u - u0)]; });
  } else {
    k16_search(hc, si, al, blk, rank, cs, p, found_o, u_o, v_o, over_o,
               [=](int v, int u) { return __ldg(map + (size_t)v * W + u); });
  }
}

// n_blocks slots x p->cluster CTAs; p->stage is set here from the dynamic
// shared memory the device allows (dyn_smem.cuh)
extern "C" int k16_multi_ellipse(const float* maps, const float* h_centres, const float* sinv,
                                 const uint8_t* alive, uint8_t* found, int* u, int* v, uint8_t* over, int n_blocks,
                                 const K16Params* p, void* stream) {
  static DynSmem ds = {(const void*)k16_kernel, {0}, {0}, 0};
  if (p->P < 0 || p->cluster < 1 || p->cluster > K16_MAX_CLUSTER || p->threads < 32 || p->threads % 32 != 0 ||
      p->threads > K16_MAX_THREADS || p->side_u < 1 || p->side_u > p->W ||
      p->side_v < 1 || p->side_v > p->H || p->band_v > p->pad_h || p->pad_w < 256 ||
      (size_t)p->W * p->H >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  int dyn_max = 0;
  cudaError_t e = ds_max(&ds, &dyn_max);
  if (e != cudaSuccess) return (int)e;
  if (n_blocks == 0 || p->P == 0) return 0;
  K16Params q = *p;
  q.stage = min(K16_STAGE_MAX, dyn_max / (int)sizeof(float));
  e = ds_prepare(&ds, (int)sizeof(float) * q.stage);
  if (e != cudaSuccess) return (int)e;
  k16_kernel<<<(unsigned)n_blocks * q.cluster, q.threads, sizeof(float) * (size_t)q.stage,
               (cudaStream_t)stream>>>(maps, h_centres, sinv, alive, found, u, v, over, q);
  return (int)cudaGetLastError();
}
