// K13: the particle-cloud search over precomputed score maps.
//
// Replaces scenelib2_tpu/kernels/pallas_particle_search.py
// (pallas_multi_ellipse_search / _kernel, pallas_call at
// pallas_particle_search.py:206, with its wrapper's geometry at :158-176),
// the batch route with SCENELIB2_BATCH_SB=0 (reference
// SearchMultipleOverlappingEllipses,
// search_multiple_overlapping_ellipses.cpp:106-196). For every particle of
// every (lane, slot), from its predicted position h and S^-1:
//   the geometry, as particle_search.py::region_geometry computes it with
//   XLA's int32 semantics: uc, vc = trunc(h) and the half-extents
//   floor(no_sigma / sqrt(a - (b b) / c)), floor(no_sigma / sqrt(c - (b b) / a))
//   converted with NaN -> 0 and saturation (__float2int_rz, which is
//   cvt.rzi.s32.f32: both by definition), every sum wrapping as int32 (taken
//   in unsigned); the window of side 2R + 1 clamped to the map and the
//   region [v_lo, v_hi) x [u_lo, u_hi), the window cut to the 3-sigma box;
//   overflow = a half-extent above R;
//   over the region's cells inside the ellipse ((a urel) urel + ((2b) urel)
//   vrel + (c vrel) vrel < no_sigma^2, urel and vrel the int32-wrapped
//   offsets as f32, the TPU kernel's operation order, built with
//   -fmad=false), the minimum of the slot's score map and the largest key
//   u*H + v among the cells at the minimum; the 1e6 of every other cell of
//   the window joins the minimum (a cell at exactly 1e6 then ties with it and
//   keeps its key; only a window that is the whole map with every cell
//   admitted has no such cell, correlate.py::window_search); an admitted NaN
//   makes the minimum NaN and leaves no key; a particle that is not alive
//   gets (1e6, -1);
//   found = alive & best <= corr_thresh2, (u, v) = (floor(key / H),
//   key mod H) (key -1: (-1, H - 1)), overflow & alive.
// The plain PyTorch twin is
// scenelib2_torch/kernels/particle_search.py::particle_search_plain; the
// kernel agrees with it bit for bit.
//
// The TPU kernel scans an (8, 128)-aligned block around each region, picked
// by a ladder of block sizes, a vector-memory economy with the same result
// (the block covers the region, the mask is the region's, and the minimum and
// the last-tie key are order-free); here only the region is read.
//
// Bound on an H100 at 64 lanes x 100 particles (particle_search.py::
// bytes_and_flops): the map cells under each slot's live regions read once
// and ~10 operations per cell of each particle's search, well under a
// microsecond on the replays' converged clouds; the launch, one chain of
// dependent loads a particle and the host glue around it set the time.
// Design (K11's search, search_bayes.cu, with K13's semantics):
//   - the wrapper launches once with the inputs as they are; every CTA
//     computes the geometry itself (k13_geom), nothing on the host;
//   - p.cluster CTAs a (lane, slot) (search_bayes.py::cluster_size's rule)
//     of K13_THREADS threads, each CTA a share of the particles
//     (interleaved: rank, rank + cluster, ...), a warp a particle; they
//     share nothing, so they are a plain grid, not a cluster;
//   - each CTA stages the read box (the bounding box of the live particles'
//     regions) of the slot's map in shared memory where it fits (p.stage
//     floats), else the searches read the map in place;
//   - a warp walks its particle's region row by row with no division (lane
//     l from cell l, 32 cells a step, one carry; K13_UNROLL steps an
//     iteration, their loads in flight together), each admitted cell one
//     64-bit key (nssd.cuh::score_key: the least value, then the largest
//     u*H + v), one unsigned minimum, a NaN flag and a count of admitted
//     cells (the whole-map rule) over the warp; lane 0 writes the results.
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dyn_smem.cuh"
#include "nssd.cuh"

#ifndef SB_MARK
#define SB_MARK(k)      // a phase boundary: scripts/sb_timeline.py stamps the time there (thread 0)
#define SB_MARK_ALL(k)  // the same once every thread of the block has reached it
#endif

#define K13_THREADS 256
#define K13_MAX_CLUSTER 8
#define K13_STAGE_MAX 16384  // floats of the stage at most (64 KB)
#define K13_LOADS 8          // loads in flight a thread while the read box is staged
#define K13_UNROLL 4         // steps of 32 cells a search iteration
#define K13_MISS 1e6f
#define K13_NONE 0xFFFFFFFFFFFFFFFFull  // the key of no admitted cell

struct K13Params {
  int H, W, P, win_radius, side_u, side_v;
  int cluster;  // CTAs a (lane, slot)
  int stage;    // floats of the stage (set at launch)
  float no_sigma, no_sigma2, corr_thresh2;
};

// int32 sums with two's-complement wrap-around, as XLA's
__device__ __forceinline__ int wrap_add(int a, int b) { return (int)((unsigned)a + (unsigned)b); }
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// one particle's geometry: particle_search.py::region_geometry
struct K13Geom {
  int uc, vc, v_lo, v_hi, u_lo, u_hi;
  float a, b2, c;
  bool over;
};

__device__ __forceinline__ K13Geom k13_geom(const float* __restrict__ hc, const float* __restrict__ sinv, int q,
                                            const K13Params& p) {
  K13Geom g;
  const int R = p.win_radius;
  // trunc, then to int32 with NaN -> 0 and saturation (cvt.rzi.s32.f32)
  g.uc = __float2int_rz(truncf(hc[2 * q]));
  g.vc = __float2int_rz(truncf(hc[2 * q + 1]));
  const float a = sinv[4 * q], b = sinv[4 * q + 1], c = sinv[4 * q + 3];
  const int hw = __float2int_rz(floorf(p.no_sigma / sqrtf(a - (b * b) / c)));
  const int hh = __float2int_rz(floorf(p.no_sigma / sqrtf(c - (b * b) / a)));
  const int u0 = min(max(wrap_sub(g.uc, R), 0), p.W - p.side_u);
  const int v0 = min(max(wrap_sub(g.vc, R), 0), p.H - p.side_v);
  g.v_lo = max(v0, wrap_sub(g.vc, hh));
  g.v_hi = min(v0 + p.side_v, wrap_add(wrap_add(g.vc, hh), 1));
  g.u_lo = max(u0, wrap_sub(g.uc, hw));
  g.u_hi = min(u0 + p.side_u, wrap_add(wrap_add(g.uc, hw), 1));
  g.a = a;
  g.b2 = 2.0f * b;
  g.c = c;
  g.over = hw > R || hh > R;
  return g;
}

// The searches of particles q0, q0 + stride, ..., a warp a particle: its
// region walked row by row with no division (lane l from cell l, 32 cells a
// step: (32 / ncol) rows and (32 % ncol) columns with one carry; K13_UNROLL
// steps an iteration, their loads in flight together). at(v, u): the map's
// value at a cell of the read box (a lane past the region reads its first
// cell and admits nothing).
template <typename At>
__device__ __forceinline__ void k13_search(const float* __restrict__ hc, const float* __restrict__ sinv,
                                           const uint8_t* __restrict__ alive_p, int blk, int q0, int stride,
                                           const K13Params& p, uint8_t* __restrict__ found_o,
                                           int* __restrict__ u_o, int* __restrict__ v_o,
                                           uint8_t* __restrict__ over_o, At at) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31, nw = blockDim.x >> 5;
  const int H = p.H;
  for (int q = q0 + stride * warp; q < p.P; q += stride * nw) {
    const K13Geom g = k13_geom(hc, sinv, q, p);
    const bool alive = alive_p[q] != 0;
    // compared, not subtracted: the bounds of an empty region may lie 2^31
    // apart; those of a region that holds a cell lie in the map
    const bool some = alive && g.u_hi > g.u_lo && g.v_hi > g.v_lo;
    const int ncol = some ? g.u_hi - g.u_lo : 0;
    const int ncell = some ? (g.v_hi - g.v_lo) * ncol : 0;
    unsigned long long key = K13_NONE;
    int cnt = 0;      // admitted cells
    bool nan = false;  // an admitted NaN
    if (ncell > 0) {
      int r = wl / ncol, cc = wl - r * ncol;
      const int dr = 32 / ncol, dc = 32 - dr * ncol;
      for (int e0 = wl; e0 < ncell; e0 += K13_UNROLL * 32) {
#pragma unroll
        for (int j = 0; j < K13_UNROLL; ++j) {
          const bool in = e0 + 32 * j < ncell;
          const int v = g.v_lo + r, u = g.u_lo + cc;
          const float urel = (float)wrap_sub(u, g.uc), vrel = (float)wrap_sub(v, g.vc);
          const float t1 = (g.a * urel) * urel;
          const float t2 = (g.b2 * urel) * vrel;
          const float t3 = (g.c * vrel) * vrel;
          const float val = at(in ? v : g.v_lo, in ? u : g.u_lo);
          const bool adm = in && ((t1 + t2) + t3) < p.no_sigma2;
          const unsigned long long k = score_key(val, u * H + v);
          cnt += adm ? 1 : 0;
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
    for (int o = 16; o > 0; o >>= 1) {
      key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    }
    nan = __any_sync(0xffffffffu, nan);
    if (wl == 0) {
      float best = K13_MISS;
      int kb = -1;
      if (alive && nan) {
        best = nanf("");
      } else if (alive) {
        best = key == K13_NONE ? INFINITY : key_score(key);
        kb = key == K13_NONE ? -1 : key_uv(key);
        // the 1e6 of the window's other cells (none where the window is the
        // whole map and every cell is admitted)
        const bool every = p.side_u == p.W && p.side_v == H && cnt == H * p.W;
        if (!every && !(best <= K13_MISS)) {
          best = K13_MISS;
          kb = -1;
        }
      }
      const size_t o = (size_t)blk * p.P + q;
      found_o[o] = alive && best <= p.corr_thresh2;
      u_o[o] = kb >= 0 ? kb / H : -1;
      v_o[o] = kb >= 0 ? kb % H : H - 1;
      over_o[o] = alive && g.over;
    }
  }
}

// maps [N][H][W]; h_centres [N][P][2]; sinv [N][P][2][2]; alive [N][P];
// found, u, v, over [N][P]; CTA b serves (lane, slot) b / p.cluster
__global__ void __launch_bounds__(K13_THREADS)
k13_kernel(const float* __restrict__ maps, const float* __restrict__ h_centres, const float* __restrict__ sinv,
           const uint8_t* __restrict__ alive, uint8_t* __restrict__ found_o, int* __restrict__ u_o,
           int* __restrict__ v_o, uint8_t* __restrict__ over_o, K13Params p) {
  extern __shared__ float stage[];
  __shared__ int wcell[K13_THREADS / 32][4];  // the warps' read boxes
  const int t = threadIdx.x, T = blockDim.x, warp = t >> 5, wl = t & 31, nw = T >> 5;
  const int cs = p.cluster, rank = (int)(blockIdx.x % cs), blk = (int)(blockIdx.x / cs);
  const int H = p.H, W = p.W, P = p.P;
  const float* __restrict__ map = maps + (size_t)blk * H * W;
  const float* __restrict__ hc = h_centres + (size_t)blk * P * 2;
  const float* __restrict__ si = sinv + (size_t)blk * P * 4;
  const uint8_t* __restrict__ al = alive + (size_t)blk * P;

  SB_MARK(0);
  // ---- the read box: the bounding box of the live particles' regions
  int rd[4];  // [rd0, rd1) x [rd2, rd3); all 0 when no search reads a cell
  {
    int cb[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
    for (int l = t; l < P; l += T) {
      if (al[l] == 0) continue;
      const K13Geom g = k13_geom(hc, si, l, p);
      if (g.v_hi <= g.v_lo || g.u_hi <= g.u_lo) continue;
      cb[0] = min(cb[0], g.v_lo);
      cb[1] = max(cb[1], g.v_hi);
      cb[2] = min(cb[2], g.u_lo);
      cb[3] = max(cb[3], g.u_hi);
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
  SB_MARK(3);

  // ---- the read box staged, K13_LOADS loads in flight a thread
  const bool staged = rh > 0 && rh * rw <= p.stage;
  if (staged) {
    for (int e0 = t; e0 < rh * rw; e0 += K13_LOADS * T) {
      float x[K13_LOADS];
#pragma unroll
      for (int j = 0; j < K13_LOADS; ++j) {
        const int e = min(e0 + j * T, rh * rw - 1), r = e / rw;
        x[j] = __ldg(map + (size_t)(rd[0] + r) * W + rd[2] + (e - r * rw));
      }
#pragma unroll
      for (int j = 0; j < K13_LOADS; ++j)
        if (e0 + j * T < rh * rw) stage[e0 + j * T] = x[j];
    }
    __syncthreads();
  }
  SB_MARK(15);

  // ---- this CTA's particles, a warp a particle
  if (staged) {
    const float* st = stage;
    const int v0 = rd[0], u0 = rd[2];
    k13_search(hc, si, al, blk, rank, cs, p, found_o, u_o, v_o, over_o,
               [=](int v, int u) { return st[(v - v0) * rw + (u - u0)]; });
  } else {
    k13_search(hc, si, al, blk, rank, cs, p, found_o, u_o, v_o, over_o,
               [=](int v, int u) { return __ldg(map + (size_t)v * W + u); });
  }
  SB_MARK_ALL(5);
}

// n_blocks (lane, slot) pairs x p->cluster CTAs; p->stage is set here from
// the dynamic shared memory the device allows (dyn_smem.cuh)
extern "C" int k13_particle_search(const float* maps, const float* h_centres, const float* sinv,
                                   const uint8_t* alive, uint8_t* found, int* u, int* v, uint8_t* over,
                                   int n_blocks, const K13Params* p, void* stream) {
  static DynSmem ds = {(const void*)k13_kernel, {0}, {0}, 0};
  if (p->P < 0 || p->cluster < 1 || p->cluster > K13_MAX_CLUSTER || p->side_u < 1 || p->side_u > p->W ||
      p->side_v < 1 || p->side_v > p->H || (size_t)p->W * p->H >= (1u << 31))
    return (int)cudaErrorInvalidValue;
  int dyn_max = 0;
  cudaError_t e = ds_max(&ds, &dyn_max);
  if (e != cudaSuccess) return (int)e;
  if (n_blocks == 0 || p->P == 0) return 0;
  K13Params q = *p;
  q.stage = min(K13_STAGE_MAX, dyn_max / (int)sizeof(float));
  e = ds_prepare(&ds, (int)sizeof(float) * q.stage);
  if (e != cudaSuccess) return (int)e;
  k13_kernel<<<(unsigned)n_blocks * q.cluster, K13_THREADS, sizeof(float) * (size_t)q.stage,
               (cudaStream_t)stream>>>(maps, h_centres, sinv, alive, found, u, v, over, q);
  return (int)cudaGetLastError();
}
