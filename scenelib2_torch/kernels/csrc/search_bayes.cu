// K4 and K11: particle search and Bayes update of partial features.
//
// Both replace scenelib2_tpu/kernels/pallas_search_bayes.py
// (pallas_search_bayes / _kernel), in its two modes, with one kernel body
// (sb_body) and a template parameter, wrapped as the kernels k4_kernel and
// k11_kernel:
//   K4  (PRE = false): merged + frame + full-width mode, one partial slot of
//       the single-stream step: particle predict, the scores built from the
//       frame, per-particle search, Bayes update. Twin:
//       scenelib2_torch/kernels/search_bayes.py::search_bayes_plain.
//   K11 (PRE = true): pred_rows + precomputed score map + compact rows, one
//       cluster per (lane, slot) of the batch step: the prediction rows come
//       from K10, the scores are read from K9's map (no workspace), prob /
//       lam / palive are the slots' [NP] rows. Twin: search_bayes_maps_plain.
// The particle chain, the Bayes tail, the score and its integer sums are
// particle_chain.cuh, bayes_tail.cuh, nssd.cuh and window_sums.cuh. Every
// float operation follows the twins' order (built with -fmad=false); the
// window sums are integers, exact in any order; the searches are
// comparison-based.
//
// Bound on an H100 (search_bayes.py::bytes_and_flops, bytes_and_flops_maps):
// the state rows in and out (~60 KB for K4 at hires), the frame pixels under
// the cells that the searches can read and those cells' sums and score
// formula (K4), K9's map cells under them (K11), and ~12 operations a cell
// that a particle's search visits: a few microseconds of f32 work at most,
// typically well under one. The parent's timeline (scripts/sb_timeline.py)
// showed one 1,024-thread block spending its time in the scores (K4) and
// the searches (both), each a chain of loads on one SM, then in thread 0's
// prologue and 63 barriers of seven tree sums. Design: a slot is a
// thread-block cluster of p.cluster CTAs (the wrapper picks it) of
// p.threads threads (a power of two, at least bayes.py::tree_width(NP) / 4);
// thread t holds the particles t, t + p.threads, ... (bayes_tail.cuh's
// chunks: NC = 1 up to p.threads lanes of the tree, NC = 4 up to 4,096
// particles; beyond that NC = 0: one CTA of 1,024 threads loops over the
// row, the per-particle arrays below move from dynamic shared memory to a
// global workspace that the wrapper allocates, and the tail is
// bayes_tail_wide, with the same trees). Every CTA:
//   1. the slot geometry prologue over the threads (K4;
//      particle_chain.cuh) and the particle chain of every particle into
//      prediction rows [8][NP] (K11: K10's rows loaded);
//   2. the union box of the searchable particles (each thread over its
//      particles, the warps, then every thread over the warps' boxes), the
//      scanned region (the union box's rows x the 128-column chunks that
//      meet its columns, as the TPU kernel scans) and the read box: the
//      bounding box of every particle's box within the region, the only
//      cells that a search can read;
//   3. K4: its band of the read box's rows (search_bayes.py::band) scored
//      into the [H, W] workspace (frame words staged in passes, four
//      centres a thread by __dp4a, the penalized NSSD), then a cluster
//      barrier;
//   4. the read box's scores (K9's map for K11) staged in shared memory
//      where they fit (p.stage floats), else read in place;
//   5. its share of the particles (rank, rank + cluster, ...), a warp a
//      particle walking the box's cells row by row with no division, one
//      64-bit key a cell (nssd.cuh::score_key), one unsigned minimum; each
//      result lands in CTA 0's shared memory, then a cluster barrier;
//   6. CTA 0: the Bayes tail (three passes of fused tree sums) and the
//      slot's outputs; the other CTAs (K4): the pass-through copy of every
//      other row of prob / palive in 16-byte units.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "bayes_tail.cuh"
#include "nssd.cuh"
#include "particle_chain.cuh"
#include "window_sums.cuh"

namespace cg = cooperative_groups;

#ifndef SB_MARK
#define SB_MARK(k)  // a phase boundary: scripts/sb_timeline.py stamps the time there
#endif

#define SB_MAX_THREADS 1024
#define SB_NC1_THREADS 512     // the NC = 1 kernels' most threads (their launch bound: 128 registers)
#define SB_MIN_THREADS 128     // bayes_tail.cuh's tree_sums takes 128 lanes in every warp
#define SB_MAX_CLUSTER 8       // portable cluster size
#define SB_STAGE_MAX 16384     // floats of the stage at most (64 KB)
#define SB_LOADS 8             // loads in flight a thread while the read box is staged
#define SB_UNROLL 4            // steps of 32 cells a search iteration
#define K4_MISS 1e6f
#define K4_BIG 16777216.0f
#define K4_CHUNK 128
#define SB_NONE 0xFFFFFFFFFFFFFFFFull  // the key of no admitted cell

struct K4Params {
  int H, W, B, MF, NP, win_radius;
  int pred_w;   // K11: the row width of K10's prediction rows (bayes.py::padded_lanes(NP))
  int width;    // the sums' tree width (bayes.py::tree_width(NP))
  int threads;  // a CTA's threads
  int cluster;  // CTAs a slot
  int stage;    // floats of the stage (set at launch)
  float no_sigma, corr_thresh2, corr_sigma_thresh, low_sigma_penalty;
  float fku, fkv, u0c, v0c, two_kd1, neg_two_kd1, sd0, maxdist;
  float prune_prob_thresh, sd_depth_ratio, min_particles, erase_partial_after_attempts;
};

// NaN-propagating max/min (torch.maximum / jnp.maximum semantics)
__device__ __forceinline__ float jmax(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ __forceinline__ float jmin(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }

// an integer-valued float bound as an int clamped to [lo, hi]; NaN gives
// `nan_to` (an empty range at the caller)
__device__ __forceinline__ int ibound(float v, int lo, int hi, int nan_to) {
  if (v != v) return nan_to;
  return (int)fminf(fmaxf(v, (float)lo), (float)hi);
}

// one particle's search geometry from its prediction row (search_bayes.py::
// search_geometry): the window of side_u x side_v around trunc(hpi) clamped
// to the frame, cut to the 3-sigma box [vlo, vhi) x [ulo, uhi)
struct SearchGeom {
  float uc, vc, vlo, vhi, ulo, uhi;
};

__device__ __forceinline__ SearchGeom search_geom(const float* pred, int NP, int l, const K4Params& p) {
  const float R = (float)p.win_radius;
  const float side_u = (float)min(2 * p.win_radius + 1, p.W);
  const float side_v = (float)min(2 * p.win_radius + 1, p.H);
  const float hw = pred[ROW_HW * NP + l], hh = pred[ROW_HH * NP + l];
  SearchGeom g;
  g.uc = truncf(pred[ROW_HU * NP + l]);
  g.vc = truncf(pred[ROW_HV * NP + l]);
  const float u0 = jmin(jmax(g.uc - R, 0.0f), (float)p.W - side_u);
  const float v0 = jmin(jmax(g.vc - R, 0.0f), (float)p.H - side_v);
  g.vlo = jmax(v0, g.vc - hh);
  g.vhi = jmin(v0 + side_v, g.vc + hh + 1.0f);
  g.ulo = jmax(u0, g.uc - hw);
  g.uhi = jmin(u0 + side_u, g.uc + hw + 1.0f);
  return g;
}

// the cells [r0, r1) x [c0, c1) of a particle's box within the region
// [v_lo, v_hi) x [u_lo, u_hi): every cell that the exact mask of the search
// can admit (the bounds are integer-valued or infinite; NaN: empty)
struct CellBox {
  int r0, r1, c0, c1;
};

__device__ __forceinline__ CellBox cell_box(const SearchGeom& g, const int reg[4]) {
  const int v_lo = reg[0], v_hi = reg[1], u_lo = reg[2], u_hi = reg[3];
  CellBox b;
  b.r0 = max(v_lo, ibound(floorf(g.vlo), v_lo, v_hi, v_hi));
  b.r1 = min(v_hi, ibound(ceilf(g.vhi), v_lo, v_hi, v_lo));
  b.c0 = max(u_lo, ibound(floorf(g.ulo), u_lo, u_hi, u_hi));
  b.c1 = min(u_hi, ibound(ceilf(g.uhi), u_lo, u_hi, u_lo));
  return b;
}

// f(l) for each of this thread's particles: l = t, t + blockDim.x, ... (NC
// of them at most; NC = 0: as many as the row needs)
template <int NC, typename F>
__device__ __forceinline__ void sb_particles(int NP, int nc, F f) {
  if constexpr (NC == 0) {
    for (int l = threadIdx.x; l < NP; l += blockDim.x) f(l);
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = threadIdx.x + c * blockDim.x;
      if (c < nc && l < NP) f(l);
    }
  }
}

// the CTAs of a cluster arrive at (relaxed) / wait on the cluster barrier
__device__ __forceinline__ void cluster_arrive_relaxed() { asm volatile("barrier.cluster.arrive.relaxed.aligned;\n"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// K4's scores of centre rows [ra, rb) x columns [ru0, ru1) into ws [H][W]:
// frame words staged in `words` (cap words) in passes of as many centre
// rows as fit, WS_RUN centres a thread, K4_MISS at an invalid centre
__device__ void k4_scores(const uint8_t* __restrict__ frame, const uint32_t* pq, const float* patch_row, int ra,
                          int rb, int ru0, int ru1, float* __restrict__ ws, uint32_t* words, int cap,
                          const K4Params& p) {
  const int B = p.B, half = (B - 1) / 2, H = p.H, W = p.W;
  const int t = threadIdx.x, T = blockDim.x;
  const int nrun = (ru1 - ru0 + WS_RUN - 1) / WS_RUN;
  const int spw = nrun + 3;  // a run reads 4 words from its own
  const int pass = max(cap / spw - (B - 1), 1);
  uint32_t msk[WS_NQ];
  quad_masks(B, msk);
  const float sg0 = patch_row[B * B], sg0sq = patch_row[B * B + 1], n = (float)(B * B);
  for (int r0 = ra; r0 < rb; r0 += pass) {
    const int r1 = min(rb, r0 + pass);
    __syncthreads();  // the previous pass's words are read
    for (int e = t; e < (r1 - r0 + B - 1) * spw; e += T) {
      const int r = e / spw, j = e - r * spw;
      const int y = r0 - half + r, x0 = ru0 - half + WS_RUN * j;
      uint32_t w = 0;
      if (y >= 0 && y < H) {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (x0 + k >= 0 && x0 + k < W) w |= (uint32_t)frame[(size_t)y * W + x0 + k] << (8 * k);
      }
      words[e] = w;
    }
    __syncthreads();
    for (int it = t; it < (r1 - r0) * nrun; it += T) {
      const int r = it / nrun, i = it - r * nrun;
      const int v = r0 + r;
      uint32_t cross[WS_RUN], s1[WS_RUN], s2[WS_RUN];
      run_sums(words + r * spw + i, spw, B, pq, msk, cross, s1, s2);
#pragma unroll
      for (int s = 0; s < WS_RUN; ++s) {
        const int u = ru0 + WS_RUN * i + s;
        if (u >= ru1) continue;
        const bool valid = u >= half && u <= W - 1 - half && v >= half && v <= H - 1 - half;
        ws[(size_t)v * W + u] = valid ? nssd_penalized(sg0, sg0sq, (float)s1[s], (float)s2[s], (float)cross[s], n,
                                                       p.corr_sigma_thresh, p.low_sigma_penalty)
                                      : K4_MISS;
      }
    }
  }
}

// The searches of particles q0, q0 + stride, ..., a warp a particle (the
// CTAs of a cluster and their warps interleave over the particles, so each
// takes near and far depths alike): the cells of its box walked row by row
// with no division (lane l from cell l of the box, 32 cells a step:
// (32 / ncol) rows and (32 % ncol) columns with one carry; SB_UNROLL steps
// an iteration, their loads in flight together),
// the exact mask of particle_search, each admitted cell below K4_MISS one
// 64-bit key (nssd.cuh::score_key), each lane keeping the least by a
// select, the warp's unsigned minimum; lane 0 writes the best score
// (K4_MISS: none) and its u * H + v (-1: none).
// at(v, u): the score of a cell of the read box (a lane past the box reads
// the box's first cell and admits nothing).
template <typename At>
__device__ __forceinline__ void search_share(const float* pred, int NP, int q0, int stride, const int reg[4],
                                             const K4Params& p, float* best_to, float* kbest_to, At at) {
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31, nw = blockDim.x >> 5;
  const float no_sigma2 = p.no_sigma * p.no_sigma;
  for (int q = q0 + stride * warp; q < NP; q += stride * nw) {
    const SearchGeom g = search_geom(pred, NP, q, p);
    const CellBox b = cell_box(g, reg);
    const float a = pred[ROW_S00 * NP + q], b2 = 2.0f * pred[ROW_S01 * NP + q], c = pred[ROW_S11 * NP + q];
    const int ncol = b.c1 - b.c0, ncell = ncol > 0 ? max(b.r1 - b.r0, 0) * ncol : 0;
    unsigned long long key = SB_NONE;
    if (ncell > 0) {
      int r = wl / ncol, cc = wl - r * ncol;
      const int dr = 32 / ncol, dc = 32 - dr * ncol;
      for (int e0 = wl; e0 < ncell; e0 += SB_UNROLL * 32) {
#pragma unroll
        for (int j = 0; j < SB_UNROLL; ++j) {
          const bool in = e0 + 32 * j < ncell;
          const int v = b.r0 + r, u = b.c0 + cc;
          const float vf = (float)v, uf = (float)u;
          const float urel = uf - g.uc, vrel = vf - g.vc;
          const float t1 = (a * urel) * urel;
          const float t2 = (b2 * urel) * vrel;
          const float vterm = (c * vrel) * vrel;
          const float val = at(in ? v : b.r0, in ? u : b.c0);
          const unsigned long long k = score_key(val, u * p.H + v);
          const bool mask = in && vf >= g.vlo && vf < g.vhi && uf >= g.ulo && uf < g.uhi &&
                            ((t1 + t2) + vterm) < no_sigma2;
          key = (mask && val < K4_MISS && k < key) ? k : key;
          cc += dc;
          r += dr;
          if (cc >= ncol) {
            cc -= ncol;
            ++r;
          }
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (wl == 0) {
      best_to[q] = key == SB_NONE ? K4_MISS : key_score(key);
      kbest_to[q] = key == SB_NONE ? -1.0f : (float)key_uv(key);
    }
  }
}

// dst = src on the n elements of an [MF][NP] array but row `skip`: 16-byte
// units where both are 16-byte aligned, element by element where a unit
// meets the row, the tail and otherwise; units i0, i0 + stride, ...
template <typename E>
__device__ void copy_rows_but(const E* __restrict__ src, E* __restrict__ dst, int n, int NP, int skip, int i0,
                              int stride) {
  constexpr int per = 16 / sizeof(E);
  const int lo = skip * NP, hi = lo + NP;
  const bool vec = ((uintptr_t)src % 16 == 0) && ((uintptr_t)dst % 16 == 0);
  const int nv = vec ? n / per : 0;
  for (int k = i0; k < nv; k += stride) {
    const int a = k * per;
    if (a + per <= lo || a >= hi) {
      reinterpret_cast<uint4*>(dst)[k] = __ldg(reinterpret_cast<const uint4*>(src) + k);
    } else {
      for (int e = a; e < a + per; ++e)
        if (e < lo || e >= hi) dst[e] = src[e];
    }
  }
  for (int e = nv * per + i0; e < n; e += stride)
    if (e < lo || e >= hi) dst[e] = src[e];
}

// floats of sb_body's dynamic shared memory before the stage: the
// prediction rows [8][NP], best [NP], key [NP] and the tail's tree (NC > 0;
// NC = 0: in wide_ws)
__host__ __device__ inline size_t sb_rows_floats(int NP, int threads, bool wide) {
  return wide ? 0 : (size_t)(NROWS + 2) * NP + BT_TREE_FLOATS(threads);
}

// PRE = false (K4): frame is the u8 frame, corr_maps and pred_in are unused,
// prob / lam / palive are the whole [MF, NP] arrays and pidx_p picks the row.
// PRE = true (K11): cluster blk serves (lane, slot) blk; corr_maps [blk][H][W]
// and pred_in [blk][8][pred_w] are read, prob / lam / palive / outputs are
// [blk][NP] rows, making / pmask / ma and the scalars are [blk]; frame,
// pidx_p, patch_row, shared_row, slot_row, pred_o and ws are unused.
// NC = 1 or BT_MAX_CHUNKS: the per-particle arrays in dynamic shared memory;
// NC = 0 (rows of more than BT_MAX_CHUNKS x SB_MAX_THREADS particles, one
// CTA a slot): in wide_ws, (NROWS + 2) NP + width floats a slot.
template <bool PRE, int NC>
__device__ __forceinline__ void
sb_body(const uint8_t* __restrict__ frame, const float* __restrict__ corr_maps,
        const float* __restrict__ pred_in, const float* __restrict__ prob,
        const float* __restrict__ lam, const uint8_t* __restrict__ palive,
        const uint8_t* __restrict__ making_p, const uint8_t* __restrict__ pmask_p,
        const int* __restrict__ ma_p, const int* __restrict__ pidx_p,
        const float* __restrict__ patch_row, const float* __restrict__ shared_row,
        const float* __restrict__ slot_row, float* __restrict__ prob_o,
        uint8_t* __restrict__ palive_o, float* __restrict__ mean_o, float* __restrict__ cov_o,
        uint8_t* __restrict__ convert_o, uint8_t* __restrict__ kill_o, int* __restrict__ nover_o,
        uint8_t* __restrict__ found_o, float* __restrict__ z_o, float* __restrict__ best_o,
        float* __restrict__ pred_o, float* __restrict__ ws, float* wide_ws, K4Params p) {
  __shared__ float geom[GEOM_N];
  __shared__ float scratch[PROLOGUE_SCRATCH];
  __shared__ uint32_t pq[WS_MAX_B * WS_NQ];
  __shared__ float wbox[SB_MAX_THREADS / 32][4];  // the warps' union boxes
  __shared__ int wcell[SB_MAX_THREADS / 32][4];   // the warps' read boxes
  extern __shared__ float dyn[];
  const int t = threadIdx.x, T = blockDim.x, warp = t >> 5, wl = t & 31, nw = T >> 5;
  const int NP = p.NP, H = p.H, W = p.W, cs = p.cluster;
  const int rank = (int)(blockIdx.x % cs);          // the CTA's rank in its slot's cluster
  const int blk = PRE ? (int)(blockIdx.x / cs) : 0;
  float* pred = NC == 0 ? wide_ws + (size_t)blk * (NROWS + 2) * NP + (size_t)blk * p.width : dyn;  // [NROWS][NP]
  float* s_best = pred + NROWS * NP;   // [NP]
  float* s_kbest = s_best + NP;        // [NP]
  float* buf = NC == 0 ? s_kbest + NP : dyn + (NROWS + 2) * NP;       // the tail's tree
  float* stage = NC == 0 ? dyn : dyn + sb_rows_floats(NP, T, false);  // p.stage floats
  const int nc = bt_nc<NC>(NP);
  const int pidx = PRE ? blk : pidx_p[0];  // the row of prob / lam / palive
  const bool making = making_p[blk] != 0;
  const bool pmask = pmask_p[blk] != 0;
  const float ma = (float)ma_p[blk];
  // the scores the searches read: K9's map of this (lane, slot), or the workspace
  const float* __restrict__ scores = PRE ? corr_maps + (size_t)blk * H * W : ws;

  // ---- 1. prologue, particle chain ------------------------------------------
  SB_MARK(0);
  if (cs > 1) cluster_arrive_relaxed();  // waited on before the first write to another CTA
  if (!PRE) {
    geometry_prologue(shared_row, slot_row, geom, scratch, t, T);
    patch_quads(patch_row, p.B, pq, t, T);
    __syncthreads();
    SB_MARK(1);
  }
  sb_particles<NC>(NP, nc, [&](int l) {
    float pr[NROWS];
    if (PRE) {
      for (int r = 0; r < NROWS; ++r) pr[r] = pred_in[((size_t)blk * NROWS + r) * p.pred_w + l];
    } else {
      const ParticleConsts pc = {p.fku, p.fkv, p.u0c, p.v0c, p.two_kd1, p.neg_two_kd1, p.sd0,
                                 p.maxdist, p.no_sigma};
      particle_tail(lam[pidx * NP + l], geom, pc, pr);
    }
    for (int r = 0; r < NROWS; ++r) {
      pred[r * NP + l] = pr[r];
      if (!PRE && rank == 0) pred_o[r * NP + l] = pr[r];
    }
  });
  __syncthreads();
  SB_MARK(2);

  // ---- 2. union box, scanned region, read box --------------------------------
  // each thread its own particles, then the warps, then every thread over
  // the warps (min / max of values that are never NaN: the order does not
  // matter)
  int reg[4];  // v_lo, v_hi, u_lo, u_hi of the scanned region
  {
    float box[4] = {K4_BIG, -K4_BIG, K4_BIG, -K4_BIG};  // v_lo, v_hi, u_lo, u_hi
    sb_particles<NC>(NP, nc, [&](int l) {
      if (!(palive[pidx * NP + l] != 0 && making)) return;
      const SearchGeom g = search_geom(pred, NP, l, p);
      if (!(g.vlo < g.vhi && g.ulo < g.uhi)) return;
      box[0] = fminf(box[0], g.vlo);
      box[1] = fmaxf(box[1], g.vhi);
      box[2] = fminf(box[2], g.ulo);
      box[3] = fmaxf(box[3], g.uhi);
    });
    for (int o = 16; o > 0; o >>= 1) {
      box[0] = fminf(box[0], __shfl_xor_sync(0xffffffffu, box[0], o));
      box[1] = fmaxf(box[1], __shfl_xor_sync(0xffffffffu, box[1], o));
      box[2] = fminf(box[2], __shfl_xor_sync(0xffffffffu, box[2], o));
      box[3] = fmaxf(box[3], __shfl_xor_sync(0xffffffffu, box[3], o));
    }
    if (wl == 0)
      for (int k = 0; k < 4; ++k) wbox[warp][k] = box[k];
  }
  __syncthreads();
  {
    float v_lo_s = K4_BIG, v_hi_s = -K4_BIG, u_lo_s = K4_BIG, u_hi_s = -K4_BIG;
    for (int w = 0; w < nw; ++w) {
      v_lo_s = fminf(v_lo_s, wbox[w][0]);
      v_hi_s = fmaxf(v_hi_s, wbox[w][1]);
      u_lo_s = fminf(u_lo_s, wbox[w][2]);
      u_hi_s = fmaxf(u_hi_s, wbox[w][3]);
    }
    const float Hf = (float)H;
    const int n_rows = (int)fmaxf(fminf(fmaxf(v_hi_s, 0.0f), Hf) - fminf(fmaxf(v_lo_s, 0.0f), Hf), 0.0f);
    const int v_lo = (int)fminf(fmaxf(v_lo_s, 0.0f), Hf);
    int k_first = -1, k_last = -1;
    for (int k = 0; k * K4_CHUNK < W; ++k) {
      const bool need = (float)(K4_CHUNK * k) <= u_hi_s - 1.0f &&
                        (float)(K4_CHUNK * k + K4_CHUNK - 1) >= u_lo_s;
      if (need) {
        if (k_first < 0) k_first = k;
        k_last = k;
      }
    }
    if (n_rows > 0 && k_first >= 0) {
      reg[0] = v_lo;
      reg[1] = v_lo + n_rows;
      reg[2] = K4_CHUNK * k_first;
      reg[3] = min(W, K4_CHUNK * (k_last + 1));
    } else {
      reg[0] = reg[1] = reg[2] = reg[3] = 0;
    }
  }
  int rd[4];  // the read box [rd0, rd1) x [rd2, rd3); all 0 when no search reads a cell
  {
    int cb[4] = {INT_MAX, INT_MIN, INT_MAX, INT_MIN};
    sb_particles<NC>(NP, nc, [&](int l) {
      const CellBox b = cell_box(search_geom(pred, NP, l, p), reg);
      if (b.r1 <= b.r0 || b.c1 <= b.c0) return;
      cb[0] = min(cb[0], b.r0);
      cb[1] = max(cb[1], b.r1);
      cb[2] = min(cb[2], b.c0);
      cb[3] = max(cb[3], b.c1);
    });
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

  // ---- 3. K4: this CTA's band of the read box's rows scored, cluster barrier
  cg::cluster_group cluster = cg::this_cluster();
  if (cs > 1) cluster_wait();  // every CTA of the cluster has started
  if (!PRE) {
    k4_scores(frame, pq, patch_row, rd[0] + rh * rank / cs, rd[0] + rh * (rank + 1) / cs, rd[2], rd[3], ws,
              reinterpret_cast<uint32_t*>(stage), p.stage, p);
    if (cs > 1) cluster.sync();  // release / acquire at cluster scope: the workspace too
    else __syncthreads();
    SB_MARK(4);
  }

  // ---- 4. the read box's scores staged, SB_LOADS loads in flight a thread --
  const bool staged = rh > 0 && rh * rw <= p.stage;
  if (staged) {
    for (int e0 = t; e0 < rh * rw; e0 += SB_LOADS * T) {
      float x[SB_LOADS];
#pragma unroll
      for (int j = 0; j < SB_LOADS; ++j) {
        const int e = min(e0 + j * T, rh * rw - 1), r = e / rw;
        const float* s = scores + (size_t)(rd[0] + r) * W + rd[2] + (e - r * rw);
        x[j] = PRE ? __ldg(s) : __ldcg(s);
      }
#pragma unroll
      for (int j = 0; j < SB_LOADS; ++j)
        if (e0 + j * T < rh * rw) stage[e0 + j * T] = x[j];
    }
  }
  __syncthreads();
  SB_MARK(15);

  // ---- 5. this CTA's particles, a warp a particle -----------------------------
  {
    float* best_to = cs > 1 ? cluster.map_shared_rank(s_best, 0) : s_best;
    float* kbest_to = cs > 1 ? cluster.map_shared_rank(s_kbest, 0) : s_kbest;
    if (staged) {
      const int v0 = rd[0], u0 = rd[2];
      search_share(pred, NP, rank, cs, reg, p, best_to, kbest_to,
                   [&](int v, int u) { return stage[(v - v0) * rw + (u - u0)]; });
    } else if (PRE) {
      search_share(pred, NP, rank, cs, reg, p, best_to, kbest_to,
                   [&](int v, int u) { return __ldg(scores + (size_t)v * W + u); });
    } else {
      search_share(pred, NP, rank, cs, reg, p, best_to, kbest_to,
                   [&](int v, int u) { return __ldcg(scores + (size_t)v * W + u); });
    }
  }
  if (cs > 1) cluster.sync();  // every result is in CTA 0
  else __syncthreads();
  SB_MARK(5);

  // ---- 6. CTA 0: the Bayes tail and outputs; the others: pass-through -------
  if (rank == 0) {
    // particle l's tail inputs: its row, its search result, its prediction rows
    auto lane_of = [&](int l) {
      BayesLane q;
      q.prob = prob[pidx * NP + l];
      q.lam = lam[pidx * NP + l];
      q.palive = palive[pidx * NP + l] != 0;
      const bool searchable = q.palive && making;
      const float kb = s_kbest[l];
      q.found = searchable && s_best[l] <= p.corr_thresh2;
      q.p_over = searchable && (pred[ROW_HW * NP + l] > (float)p.win_radius ||
                                pred[ROW_HH * NP + l] > (float)p.win_radius);
      q.zu = truncf((kb + 0.5f) / (float)H);
      q.zv = kb - (float)H * q.zu;
      q.hu = pred[ROW_HU * NP + l];
      q.hv = pred[ROW_HV * NP + l];
      q.a = pred[ROW_S00 * NP + l];
      q.b = pred[ROW_S01 * NP + l];
      q.c = pred[ROW_S11 * NP + l];
      q.det = pred[ROW_DET * NP + l];
      return q;
    };
    sb_particles<NC>(NP, nc, [&](int l) {
      const BayesLane q = lane_of(l);
      found_o[blk * NP + l] = q.found;
      z_o[2 * (blk * NP + l)] = q.zu;
      z_o[2 * (blk * NP + l) + 1] = q.zv;
      best_o[blk * NP + l] = s_best[l];
    });
    const BayesConsts bc = {p.prune_prob_thresh, p.sd_depth_ratio, p.min_particles,
                            p.erase_partial_after_attempts};
    BayesResult res;
    // the slot's row (K4: row pidx of the full-width arrays; K11: the slot's row)
    if constexpr (NC == 0) {
      res = bayes_tail_wide(lane_of, NP, making, pmask, ma, bc, buf, p.width, prob_o + (size_t)pidx * NP,
                            palive_o + (size_t)pidx * NP);
    } else {
      BayesLane in[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int l = t + c * T;
        BayesLane q = {0.0f, 0.0f, false, false, false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        if (c < nc && l < NP) q = lane_of(l);
        in[c] = q;
      }
      float prob_f[NC];
      bool alive_f[NC];
      res = bayes_tail<NC>(in, nc, making, pmask, ma, bc, buf, p.width, prob_f, alive_f);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int l = t + c * T;
        if (c < nc && l < NP) {
          prob_o[pidx * NP + l] = prob_f[c];
          palive_o[pidx * NP + l] = alive_f[c];
        }
      }
    }
    if (t == 0) {
      mean_o[blk] = res.mean;
      cov_o[blk] = res.cov;
      convert_o[blk] = res.convert;
      kill_o[blk] = res.kill;
      nover_o[blk] = res.n_over;
    }
    SB_MARK(13);
  }
  if (!PRE && (rank > 0 || cs == 1)) {
    // every other row passes through: CTAs 1 .. cs - 1 (CTA 0 alone: itself)
    const int i0 = (cs > 1 ? rank - 1 : 0) * T + t, stride = (cs > 1 ? cs - 1 : 1) * T;
    copy_rows_but(prob, prob_o, p.MF * NP, NP, pidx, i0, stride);
    copy_rows_but(palive, palive_o, p.MF * NP, NP, pidx, i0, stride);
  }
  SB_MARK(14);
}

template <int NC>
__global__ void __launch_bounds__(NC == 1 ? SB_NC1_THREADS : SB_MAX_THREADS)
k4_kernel(const uint8_t* frame, const float* prob, const float* lam, const uint8_t* palive,
          const uint8_t* making, const uint8_t* pmask, const int* ma, const int* pidx,
          const float* patch_row, const float* shared_row, const float* slot_row, float* prob_o,
          uint8_t* palive_o, float* mean_o, float* cov_o, uint8_t* convert_o, uint8_t* kill_o,
          int* nover_o, uint8_t* found_o, float* z_o, float* best_o, float* pred_o, float* ws,
          float* wide_ws, K4Params p) {
  sb_body<false, NC>(frame, nullptr, nullptr, prob, lam, palive, making, pmask, ma, pidx, patch_row,
                     shared_row, slot_row, prob_o, palive_o, mean_o, cov_o, convert_o, kill_o, nover_o,
                     found_o, z_o, best_o, pred_o, ws, wide_ws, p);
}

template <int NC>
__global__ void __launch_bounds__(NC == 1 ? SB_NC1_THREADS : SB_MAX_THREADS)
k11_kernel(const float* corr_maps, const float* pred_rows, const float* prob, const float* lam,
           const uint8_t* palive, const uint8_t* making, const uint8_t* pmask, const int* ma,
           float* prob_o, uint8_t* palive_o, float* mean_o, float* cov_o, uint8_t* convert_o,
           uint8_t* kill_o, int* nover_o, uint8_t* found_o, float* z_o, float* best_o, float* wide_ws,
           K4Params p) {
  sb_body<true, NC>(nullptr, corr_maps, pred_rows, prob, lam, palive, making, pmask, ma, nullptr, nullptr,
                    nullptr, nullptr, prob_o, palive_o, mean_o, cov_o, convert_o, kill_o, nover_o, found_o,
                    z_o, best_o, nullptr, nullptr, wide_ws, p);
}

// What one entry point's three kernels (NC = 0, 1, BT_MAX_CHUNKS) need at
// launch: the dynamic shared memory each may take (opted in once a device,
// `opted` a bit a device).
struct SbKernels {
  const void* fn[3];
  unsigned long long opted[3];
  int dyn_max[3];
};

// Checks *p, picks the kernel (NC = 0: rows past BT_MAX_CHUNKS x
// SB_MAX_THREADS particles, which need wide_ws and one CTA a slot; 1: the
// tree's width within the threads, at most SB_NC1_THREADS; BT_MAX_CHUNKS:
// within 4 x the threads),
// opts it in to the most dynamic shared memory the device allows, sizes the
// stage from what is left (p->stage) and launches n_slots x p->cluster CTAs
// of p->threads threads, a cluster a slot when p->cluster > 1.
template <typename... Args>
static int sb_launch(SbKernels* ks, K4Params* p, const float* wide_ws, int n_slots, void* stream,
                     Args... args) {
  const int T = p->threads, cs = p->cluster;
  const bool wide = p->NP > BT_MAX_CHUNKS * SB_MAX_THREADS;
  if (p->NP < 1 || p->width < p->NP || (p->width & (p->width - 1)) != 0 || p->B > WS_MAX_B ||
      p->B * p->B + 2 > 128 || T < SB_MIN_THREADS || T > SB_MAX_THREADS || (T & (T - 1)) != 0 || cs < 1 ||
      cs > SB_MAX_CLUSTER || (wide && (wide_ws == nullptr || cs != 1)) || (!wide && p->width > BT_MAX_CHUNKS * T))
    return (int)cudaErrorInvalidValue;
  const int kind = wide ? 0 : (p->width <= T && T <= SB_NC1_THREADS) ? 1 : 2;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(ks->opted[kind] & bit)) {
    int optin = 0;
    cudaFuncAttributes fa;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, ks->fn[kind]);
    if (e != cudaSuccess) return (int)e;
    ks->dyn_max[kind] = optin - (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(ks->fn[kind], cudaFuncAttributeMaxDynamicSharedMemorySize, ks->dyn_max[kind]);
    if (e != cudaSuccess) return (int)e;
    ks->opted[kind] |= bit;
  }
  const size_t rows = sizeof(float) * sb_rows_floats(p->NP, T, wide);
  const long long left = ((long long)ks->dyn_max[kind] - (long long)rows) / (long long)sizeof(float);
  p->stage = left < SB_STAGE_MAX ? (int)left : SB_STAGE_MAX;
  // K4's frame words (in the stage): at least one pass of B rows of the widest read box
  if (p->stage < p->B * ((p->W + WS_RUN - 1) / WS_RUN + 3)) return (int)cudaErrorInvalidValue;
  if (n_slots == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_slots * cs, 1, 1);
  cfg.blockDim = dim3((unsigned)T, 1, 1);
  cfg.dynamicSmemBytes = rows + sizeof(float) * (size_t)p->stage;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  void* argv[] = {(void*)&args..., (void*)p};
  e = cudaLaunchKernelExC(&cfg, ks->fn[kind], argv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// wide_ws: (NROWS + 2) NP + width floats where NP > BT_MAX_CHUNKS x
// SB_MAX_THREADS (search_bayes.py::wide_workspace), else unused; workspace:
// the [H, W] scores
extern "C" int k4_search_bayes(const uint8_t* frame, const float* prob, const float* lam,
                               const uint8_t* palive, const uint8_t* making, const uint8_t* pmask,
                               const int* match_attempts, const int* pidx, const float* patch_row,
                               const float* shared_row, const float* slot_row, float* prob_o,
                               uint8_t* palive_o, float* mean, float* cov, uint8_t* convert,
                               uint8_t* kill, int* n_over, uint8_t* found, float* z, float* best,
                               float* pred, float* workspace, float* wide_ws, const K4Params* p, void* stream) {
  static SbKernels ks = {{(const void*)k4_kernel<0>, (const void*)k4_kernel<1>,
                          (const void*)k4_kernel<BT_MAX_CHUNKS>}, {0, 0, 0}, {0, 0, 0}};
  K4Params q = *p;
  return sb_launch(&ks, &q, wide_ws, 1, stream, frame, prob, lam, palive, making, pmask, match_attempts, pidx,
                   patch_row, shared_row, slot_row, prob_o, palive_o, mean, cov, convert, kill, n_over, found,
                   z, best, pred, workspace, wide_ws);
}

// K11: n_blocks = lanes x slots; every array's leading dimension is the slot.
extern "C" int k11_search_bayes_maps(const float* corr_maps, const float* pred_rows, const float* prob,
                                     const float* lam, const uint8_t* palive, const uint8_t* making,
                                     const uint8_t* pmask, const int* match_attempts, float* prob_o,
                                     uint8_t* palive_o, float* mean, float* cov, uint8_t* convert,
                                     uint8_t* kill, int* n_over, uint8_t* found, float* z, float* best,
                                     float* wide_ws, int n_blocks, const K4Params* p, void* stream) {
  static SbKernels ks = {{(const void*)k11_kernel<0>, (const void*)k11_kernel<1>,
                          (const void*)k11_kernel<BT_MAX_CHUNKS>}, {0, 0, 0}, {0, 0, 0}};
  if (p->pred_w < p->NP) return (int)cudaErrorInvalidValue;
  K4Params q = *p;
  return sb_launch(&ks, &q, wide_ws, n_blocks, stream, corr_maps, pred_rows, prob, lam, palive, making, pmask,
                   match_attempts, prob_o, palive_o, mean, cov, convert, kill, n_over, found, z, best, wide_ws);
}
