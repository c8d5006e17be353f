// K4 and K11: particle search and Bayes update of partial features.
//
// Both replace scenelib2_tpu/kernels/pallas_search_bayes.py
// (pallas_search_bayes / _kernel), in its two modes, with one kernel body
// (sb_body) and a template parameter, wrapped as the kernels k4_kernel and
// k11_kernel:
//   K4  (PRE = false): merged + frame + full-width mode, one partial slot of
//       the single-stream step: particle predict, union-box score map built
//       from the frame, per-particle search, Bayes update. Twin:
//       scenelib2_torch/kernels/search_bayes.py::search_bayes_plain.
//   K11 (PRE = true): pred_rows + precomputed score map + compact rows, one
//       block per (lane, slot) of the batch step: the prediction rows come
//       from K10, the scores are read from K9's map (no workspace), prob /
//       lam / palive are the slots' [NP] rows. Twin: search_bayes_maps_plain.
// The particle chain, the Bayes tail and the score are particle_chain.cuh,
// bayes_tail.cuh and nssd.cuh. Every float operation follows the twins'
// order (built with -fmad=false); the box sums are integers, exact in any
// order; the searches are comparison-based.
//
// Bound on an H100: ~60 KB in and out and, in the worst case (a union box
// over the whole frame), ~77 k scored cells x 3 x 121 multiply-adds:
// ~3 us at the f32 rate; typically far less. Design: one block of 1024
// threads, in phases separated by __syncthreads; thread t holds the
// particles t, t + 1024, ... (bayes_tail.cuh's chunks; each kernel is built
// for NC = 1 and NC = 4 chunks a thread and picks one at launch, so that up
// to 1,024 particles it keeps no per-thread arrays; beyond 4,096 particles
// NC = 0: the threads loop over the row, the per-particle arrays below move
// from dynamic shared memory to a global workspace that the wrapper
// allocates, and the tail is bayes_tail_wide, with the same trees):
//   1. thread 0: the slot geometry prologue; each thread: the particle chain
//      of its particles into the prediction rows (dynamic shared memory,
//      [8][NP]);
//   2. the union box (each thread over its particles, then a warp and a
//      block reduction) and, on thread 0, the scanned region (the union
//      box's rows x the 128-column chunks that meet its columns, as the TPU
//      kernel scans); each particle's search geometry comes from its
//      prediction row (search_geom), wherever it is needed;
//   3. all threads: the penalized NSSD of every scanned centre into the
//      global workspace [H, W] (300 KB does not fit in shared memory);
//   4. each warp: its particles, lanes striding over the particle's box,
//      then a warp reduction (min score, then the largest u*H + v key);
//   5. each thread: the Bayes tail of its particles; all threads: the
//      full-width copy of prob / palive, the slot's row from the tail.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bayes_tail.cuh"
#include "nssd.cuh"
#include "particle_chain.cuh"

#define K4_THREADS 1024
#define K4_MISS 1e6f
#define K4_BIG 16777216.0f
#define K4_CHUNK 128

struct K4Params {
  int H, W, B, MF, NP, win_radius;
  int pred_w;  // K11: the row width of K10's prediction rows (bayes.py::padded_lanes(NP))
  int width;   // the sums' tree width (bayes.py::tree_width(NP))
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

// penalized NSSD at centre (v, u): nssd_corr_f32 of kernels/search.py on
// exact integer box sums, + the low-sigma penalty; K4_MISS at an invalid
// centre
__device__ float penalized_score(const uint8_t* __restrict__ frame, const float* patch, int v, int u,
                                 const K4Params& p) {
  const int B = p.B, half = (B - 1) / 2;
  if (u < half || u > p.W - 1 - half || v < half || v > p.H - 1 - half) return K4_MISS;
  float sg1 = 0.0f, sg1sq = 0.0f, cross = 0.0f;
  for (int dy = 0; dy < B; ++dy) {
    const uint8_t* row = frame + (v - half + dy) * p.W + (u - half);
    const float* prow = patch + dy * B;
    for (int dx = 0; dx < B; ++dx) {
      const float w = (float)row[dx];
      sg1 = sg1 + w;
      sg1sq = sg1sq + w * w;
      cross = cross + prow[dx] * w;
    }
  }
  return nssd_penalized(patch[B * B], patch[B * B + 1], sg1, sg1sq, cross, (float)(B * B),
                        p.corr_sigma_thresh, p.low_sigma_penalty);
}

// (value, key) order of the search: the smaller value, then the larger key
__device__ __forceinline__ bool beats(float v, float k, float bv, float bk) {
  return v < bv || (v == bv && k > bk);
}

// one particle's search geometry from its prediction row (search_bayes.py::
// search_geometry): the window of side_u x side_v around trunc(hpi) clamped
// to the frame, cut to the 3-sigma box [vlo, vhi) x [ulo, uhi); over = a
// half-extent beyond the radius
struct SearchGeom {
  float uc, vc, vlo, vhi, ulo, uhi;
  bool over;
};

__device__ __forceinline__ SearchGeom search_geom(float hu, float hv, float hw, float hh, const K4Params& p) {
  const float R = (float)p.win_radius;
  const float side_u = (float)min(2 * p.win_radius + 1, p.W);
  const float side_v = (float)min(2 * p.win_radius + 1, p.H);
  SearchGeom g;
  g.uc = truncf(hu);
  g.vc = truncf(hv);
  const float u0 = jmin(jmax(g.uc - R, 0.0f), (float)p.W - side_u);
  const float v0 = jmin(jmax(g.vc - R, 0.0f), (float)p.H - side_v);
  g.over = hw > R || hh > R;
  g.vlo = jmax(v0, g.vc - hh);
  g.vhi = jmin(v0 + side_v, g.vc + hh + 1.0f);
  g.ulo = jmax(u0, g.uc - hw);
  g.uhi = jmin(u0 + side_u, g.uc + hw + 1.0f);
  return g;
}

// dynamic shared memory of sb_body for NP particles: the prediction rows
// [8][NP], best [NP], key [NP], the tree buffer [width]
static size_t sb_smem(int NP, int width) { return sizeof(float) * ((size_t)10 * NP + width); }

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

// PRE = false (K4): frame is the u8 frame, corr_maps and pred_in are unused,
// prob / lam / palive are the whole [MF, NP] arrays and pidx_p picks the row.
// PRE = true (K11): block blk serves (lane, slot) blk; corr_maps [blk][H][W]
// and pred_in [blk][8][pred_w] are read, prob / lam / palive / outputs are
// [blk][NP] rows, making / pmask / ma and the scalars are [blk]; frame,
// pidx_p, patch_row, shared_row, slot_row, pred_o and ws are unused.
// NC = 1 or BT_MAX_CHUNKS: the per-particle arrays in dynamic shared memory;
// NC = 0 (rows of more than BT_MAX_CHUNKS x K4_THREADS particles): in
// wide_ws, sb_smem's floats a block (K11: block blk at blk x that).
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
  __shared__ float patch[128];
  __shared__ int scan[4];  // v_lo, v_hi, u_lo, u_hi of the scanned region
  __shared__ float red[K4_THREADS / 32][4];  // the warps' union boxes
  extern __shared__ float dyn[];
  const int t = threadIdx.x, nt = blockDim.x;
  const int NP = p.NP, H = p.H, W = p.W;
  const int blk = PRE ? blockIdx.x : 0;
  float* pred = NC == 0 ? wide_ws + (size_t)blk * (NROWS + 2) * NP + (size_t)blk * p.width : dyn;  // [NROWS][NP]
  float* s_best = pred + NROWS * NP;   // [NP]
  float* s_kbest = s_best + NP;        // [NP]
  float* buf = s_kbest + NP;           // [width]
  const int nc = bt_nc<NC>(NP);
  const int pidx = PRE ? blk : pidx_p[0];  // the row of prob / lam / palive
  const bool making = making_p[blk] != 0;
  const bool pmask = pmask_p[blk] != 0;
  const float ma = (float)ma_p[blk];
  // the scores the searches read: K9's map of this (lane, slot), or the workspace
  const float* __restrict__ scores = PRE ? corr_maps + (size_t)blk * H * W : ws;

  // ---- 1. prologue, particle chain ------------------------------------------
  if (!PRE) {
    if (t == 0) geometry_prologue(shared_row, slot_row, geom);
    if (t < 128) patch[t] = patch_row[t];
    __syncthreads();
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
      if (!PRE) pred_o[r * NP + l] = pr[r];
    }
  });
  __syncthreads();

  // ---- 2. union box and scanned region ------------------------------------
  // each thread its own particles, then the warps, then thread 0 (min / max
  // of values that are never NaN: the order does not matter)
  const int warp = t >> 5, wl = t & 31;
  {
    float box[4] = {K4_BIG, -K4_BIG, K4_BIG, -K4_BIG};  // v_lo, v_hi, u_lo, u_hi
    sb_particles<NC>(NP, nc, [&](int l) {
      if (!(palive[pidx * NP + l] != 0 && making)) return;
      const SearchGeom g = search_geom(pred[ROW_HU * NP + l], pred[ROW_HV * NP + l], pred[ROW_HW * NP + l],
                                       pred[ROW_HH * NP + l], p);
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
      for (int k = 0; k < 4; ++k) red[warp][k] = box[k];
  }
  __syncthreads();
  if (t == 0) {
    float v_lo_s = K4_BIG, v_hi_s = -K4_BIG, u_lo_s = K4_BIG, u_hi_s = -K4_BIG;
    for (int w = 0; w < nt / 32; ++w) {
      v_lo_s = fminf(v_lo_s, red[w][0]);
      v_hi_s = fmaxf(v_hi_s, red[w][1]);
      u_lo_s = fminf(u_lo_s, red[w][2]);
      u_hi_s = fmaxf(u_hi_s, red[w][3]);
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
      scan[0] = v_lo;
      scan[1] = v_lo + n_rows;
      scan[2] = K4_CHUNK * k_first;
      scan[3] = min(W, K4_CHUNK * (k_last + 1));
    } else {
      scan[0] = scan[1] = scan[2] = scan[3] = 0;
    }
  }
  __syncthreads();
  const int v_lo = scan[0], v_hi = scan[1], u_lo = scan[2], u_hi = scan[3];

  // ---- 3. scores of the scanned centres ------------------------------------
  if (!PRE) {
    const int ncols = u_hi - u_lo;
    for (int e = t; e < (v_hi - v_lo) * ncols; e += nt) {
      const int v = v_lo + e / ncols, u = u_lo + e % ncols;
      ws[v * W + u] = penalized_score(frame, patch, v, u, p);
    }
    __syncthreads();
  }

  // ---- 4. per-particle search, one warp per particle -----------------------
  const float no_sigma2 = p.no_sigma * p.no_sigma;
  for (int q = warp; q < NP; q += nt / 32) {
    const SearchGeom g = search_geom(pred[ROW_HU * NP + q], pred[ROW_HV * NP + q], pred[ROW_HW * NP + q],
                                     pred[ROW_HH * NP + q], p);
    const float uc = g.uc, vc = g.vc, ulo = g.ulo, uhi = g.uhi, vlo = g.vlo, vhi = g.vhi;
    const float a = pred[ROW_S00 * NP + q], b2 = 2.0f * pred[ROW_S01 * NP + q], c = pred[ROW_S11 * NP + q];
    // cells the exact mask below can admit: the box, within the scanned region
    const int r0 = max(v_lo, ibound(floorf(vlo), v_lo, v_hi, v_hi));
    const int r1 = min(v_hi, ibound(ceilf(vhi), v_lo, v_hi, v_lo));
    const int c0 = max(u_lo, ibound(floorf(ulo), u_lo, u_hi, u_hi));
    const int c1 = min(u_hi, ibound(ceilf(uhi), u_lo, u_hi, u_lo));
    const int ncol = max(c1 - c0, 0);
    const int ncell = max(r1 - r0, 0) * ncol;
    float best = K4_MISS, bkey = -1.0f;
    for (int e = wl; e < ncell; e += 32) {
      const int v = r0 + e / ncol, u = c0 + e % ncol;
      const float vf = (float)v, uf = (float)u;
      const float urel = uf - uc, vrel = vf - vc;
      const float t1 = (a * urel) * urel;
      const float t2 = (b2 * urel) * vrel;
      const float vterm = (c * vrel) * vrel;
      const bool mask = vf >= vlo && vf < vhi && uf >= ulo && uf < uhi && ((t1 + t2) + vterm) < no_sigma2;
      if (!mask) continue;
      const float val = scores[v * W + u];
      const float key = uf * (float)H + vf;
      if (val < K4_MISS && beats(val, key, best, bkey)) {
        best = val;
        bkey = key;
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, best, o);
      const float ok = __shfl_xor_sync(0xffffffffu, bkey, o);
      if (beats(ov, ok, best, bkey)) {
        best = ov;
        bkey = ok;
      }
    }
    if (wl == 0) {
      s_best[q] = best;
      s_kbest[q] = bkey;
    }
  }
  __syncthreads();

  // ---- 5. Bayes tail and outputs --------------------------------------------
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
  // the slot's row (K4: row pidx of the full-width arrays; K11: the block's row)
  if constexpr (NC == 0) {
    res = bayes_tail_wide(lane_of, NP, making, pmask, ma, bc, buf, p.width, prob_o + (size_t)pidx * NP,
                          palive_o + (size_t)pidx * NP);
  } else {
    BayesLane in[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = t + c * nt;
      BayesLane q = {0.0f, 0.0f, false, false, false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (c < nc && l < NP) q = lane_of(l);
      in[c] = q;
    }
    float prob_f[NC];
    bool alive_f[NC];
    res = bayes_tail<NC>(in, nc, making, pmask, ma, bc, buf, p.width, prob_f, alive_f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = t + c * nt;
      if (c < nc && l < NP) {
        prob_o[pidx * NP + l] = prob_f[c];
        palive_o[pidx * NP + l] = alive_f[c];
      }
    }
  }
  if (!PRE) {
    // every other row passes through
    for (int e = t; e < p.MF * NP; e += nt) {
      if (e / NP == pidx) continue;
      prob_o[e] = prob[e];
      palive_o[e] = palive[e];
    }
  }
  if (t == 0) {
    mean_o[blk] = res.mean;
    cov_o[blk] = res.cov;
    convert_o[blk] = res.convert;
    kill_o[blk] = res.kill;
    nover_o[blk] = res.n_over;
  }
}

template <int NC>
__global__ void __launch_bounds__(K4_THREADS)
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
__global__ void __launch_bounds__(K4_THREADS)
k11_kernel(const float* corr_maps, const float* pred_rows, const float* prob, const float* lam,
           const uint8_t* palive, const uint8_t* making, const uint8_t* pmask, const int* ma,
           float* prob_o, uint8_t* palive_o, float* mean_o, float* cov_o, uint8_t* convert_o,
           uint8_t* kill_o, int* nover_o, uint8_t* found_o, float* z_o, float* best_o, float* wide_ws,
           K4Params p) {
  sb_body<true, NC>(nullptr, corr_maps, pred_rows, prob, lam, palive, making, pmask, ma, nullptr, nullptr,
                nullptr, nullptr, prob_o, palive_o, mean_o, cov_o, convert_o, kill_o, nover_o, found_o,
                z_o, best_o, nullptr, nullptr, wide_ws, p);
}

// the chunks a thread of the launch (out: nc, 1 up to K4_THREADS particles,
// BT_MAX_CHUNKS up to BT_MAX_CHUNKS x K4_THREADS, else 0: the wide path,
// which needs wide_ws) and its dynamic shared memory (out: smem, 0 on the
// wide path); invalid if NP or width is out of range. NC = 1 needs at most
// 45 KB; the NC = 4 kernels opt in to the size of BT_MAX_CHUNKS x K4_THREADS
// particles once per device (`opted`: a bit per device) on their first
// launch there.
template <typename K>
static cudaError_t sb_prepare(K kernel4, unsigned long long* opted, const K4Params* p, const float* wide_ws,
                              size_t* smem, int* nc) {
  const int max_np = BT_MAX_CHUNKS * K4_THREADS;
  if (p->NP < 1 || p->width < p->NP || (p->width & (p->width - 1)) != 0 || p->B * p->B + 2 > 128)
    return cudaErrorInvalidValue;
  if (p->NP > max_np) {
    *nc = 0;
    *smem = 0;
    return wide_ws == nullptr ? cudaErrorInvalidValue : cudaSuccess;
  }
  *smem = sb_smem(p->NP, p->width);
  *nc = p->NP <= K4_THREADS ? 1 : BT_MAX_CHUNKS;
  if (*nc == 1) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (*opted & bit) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel4, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)sb_smem(max_np, max_np));
  if (e == cudaSuccess) *opted |= bit;
  return e;
}

// wide_ws: sb_smem(NP, width) bytes a block where NP > BT_MAX_CHUNKS x
// K4_THREADS (search_bayes.py::wide_workspace_floats), else unused
extern "C" int k4_search_bayes(const uint8_t* frame, const float* prob, const float* lam,
                               const uint8_t* palive, const uint8_t* making, const uint8_t* pmask,
                               const int* match_attempts, const int* pidx, const float* patch_row,
                               const float* shared_row, const float* slot_row, float* prob_o,
                               uint8_t* palive_o, float* mean, float* cov, uint8_t* convert,
                               uint8_t* kill, int* n_over, uint8_t* found, float* z, float* best,
                               float* pred, float* workspace, float* wide_ws, const K4Params* p, void* stream) {
  static unsigned long long opted = 0;
  size_t smem = 0;
  int nc = 1;
  const cudaError_t e = sb_prepare(k4_kernel<BT_MAX_CHUNKS>, &opted, p, wide_ws, &smem, &nc);
  if (e != cudaSuccess) return (int)e;
  auto kernel = nc == 0 ? k4_kernel<0> : nc == 1 ? k4_kernel<1> : k4_kernel<BT_MAX_CHUNKS>;
  kernel<<<1, K4_THREADS, smem, (cudaStream_t)stream>>>(
      frame, prob, lam, palive, making, pmask, match_attempts, pidx, patch_row, shared_row, slot_row,
      prob_o, palive_o, mean, cov, convert, kill, n_over, found, z, best, pred, workspace, wide_ws, *p);
  return (int)cudaGetLastError();
}

// K11: n_blocks = lanes x slots; every array's leading dimension is the block.
extern "C" int k11_search_bayes_maps(const float* corr_maps, const float* pred_rows, const float* prob,
                                     const float* lam, const uint8_t* palive, const uint8_t* making,
                                     const uint8_t* pmask, const int* match_attempts, float* prob_o,
                                     uint8_t* palive_o, float* mean, float* cov, uint8_t* convert,
                                     uint8_t* kill, int* n_over, uint8_t* found, float* z, float* best,
                                     float* wide_ws, int n_blocks, const K4Params* p, void* stream) {
  if (p->pred_w < p->NP) return (int)cudaErrorInvalidValue;
  static unsigned long long opted = 0;
  size_t smem = 0;
  int nc = 1;
  const cudaError_t e = sb_prepare(k11_kernel<BT_MAX_CHUNKS>, &opted, p, wide_ws, &smem, &nc);
  if (e != cudaSuccess) return (int)e;
  if (n_blocks == 0) return 0;
  auto kernel = nc == 0 ? k11_kernel<0> : nc == 1 ? k11_kernel<1> : k11_kernel<BT_MAX_CHUNKS>;
  kernel<<<n_blocks, K4_THREADS, smem, (cudaStream_t)stream>>>(
      corr_maps, pred_rows, prob, lam, palive, making, pmask, match_attempts, prob_o, palive_o, mean,
      cov, convert, kill, n_over, found, z, best, wide_ws, *p);
  return (int)cudaGetLastError();
}
