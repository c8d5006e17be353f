// The particle Bayes tail, block-level.
//
// The CUDA form of scenelib2_torch/kernels/bayes.py::bayes_tail, which ports
// scenelib2_tpu/kernels/pallas_bayes.py::_bayes_tail, in two forms with the
// same per-particle operations (bt_* below) and the same trees.
// bayes_tail<NC>: each thread holds the particles t, t + blockDim.x, ...
// (nc = bt_nc<NC>(NP) of them, at most the template's NC), one BayesLane
// each; particles at or beyond NP hold zeros and false. Every thread of the
// block calls it, since the sums are block reductions: the pairwise tree
// over `width` lanes (bayes.py::tree_width: the TPU kernel's padded row of
// max(128, NP rounded up to 128) lanes, zero-padded on to a power of two)
// that the twin's tree_sum takes: width / 2, ..., 1, each level adding lane
// i + s to lane i. The seven sums go through the tree in three passes
// (tree_sums: the sums of a pass side by side, one barrier a level down to
// 128 lanes, the last seven levels in every warp). The kernels are built
// for NC = 1 (width <= blockDim.x) and NC = BT_MAX_CHUNKS and pick one at
// launch. bayes_tail_wide: rows of more than BT_MAX_CHUNKS x blockDim.x
// particles; threads loop over as many chunks as the row needs, a callback
// rebuilds each particle's BayesLane from global memory, and the tree and
// the intermediates live in global memory (the tree buffer in a workspace,
// the intermediates in the row's outputs), one sum at a time.
// Included by search_bayes.cu (K4, K11) and bayes.cu (K12).
#pragma once

#include <stdint.h>

#ifndef SB_MARK
#define SB_MARK(k)  // a phase boundary: scripts/sb_timeline.py stamps the time there
#endif

#define BT_MAX_CHUNKS 4  // particles a thread holds: NP <= BT_MAX_CHUNKS x blockDim.x

struct BayesConsts {
  float prune_prob_thresh, sd_depth_ratio, min_particles, erase_partial_after_attempts;
};

struct BayesResult {
  float mean, cov;
  bool convert, kill;
  int n_over;
};

// one particle's inputs: prob, lam, palive, found, p_over, the match zu, zv,
// and its geometry hu, hv, S^-1 (a, b, c), det
struct BayesLane {
  float prob, lam;
  bool palive, found, p_over;
  float zu, zv, hu, hv, a, b, c, det;
};

// per-particle steps, shared by both forms: the likelihood and Bayes
// (prob1); the renormalised, pruned probability (prob_k) and its keep flag;
// the final probability and alive flag
__device__ __forceinline__ float bt_prob1(const BayesLane& q, bool making) {
  const float nu_u = q.zu - q.hu, nu_v = q.zv - q.hv;
  const float quad = q.a * nu_u * nu_u + 2.0f * q.b * nu_u * nu_v + q.c * nu_v * nu_v;
  const float gauss = (1.0f / sqrtf(6.283185307179586f * q.det)) * expf(-0.5f * quad);
  const float likelihood = q.found ? gauss : (q.p_over ? 1.0f : 0.0f);
  const bool upd = making && q.palive;
  return upd ? q.prob * likelihood : q.prob;
}

__device__ __forceinline__ float bt_prob_k(float prob1, bool palive, bool making, float safe_total,
                                           float thresh, bool* keep) {
  const float prob_n = making ? prob1 / safe_total : prob1;
  *keep = palive && !(making && prob_n < thresh);
  return *keep ? prob_n : 0.0f;
}

__device__ __forceinline__ float bt_prob_f(float prob_k, bool making, float total2) {
  return (making && total2 > 0.0f) ? prob_k / (total2 > 0.0f ? total2 : 1.0f) : prob_k;
}

__device__ __forceinline__ bool bt_palive_f(bool keep, bool palive, bool making) {
  return (making && keep) || (!making && palive);
}

// the row's moments and decisions from its sums
__device__ __forceinline__ BayesResult bt_result(float mean, float exp2, bool all_zero, float n_alive_f, float n_over,
                                                 bool making, bool pmask, float match_attempts,
                                                 const BayesConsts& bc) {
  const float cov = exp2 - mean * mean;
  const float ratio = sqrtf(cov) / mean;
  const bool convert = making && !all_zero && ratio < bc.sd_depth_ratio && n_alive_f > bc.min_particles;
  const bool sell_by = pmask && !convert &&
                       (match_attempts > bc.erase_partial_after_attempts || n_alive_f <= bc.min_particles);
  BayesResult r;
  r.mean = mean;
  r.cov = cov;
  r.convert = convert;
  r.kill = all_zero || sell_by;
  r.n_over = (int)n_over;
  return r;
}

// chunks a thread of the block holds for NP particles (NC = 1: one, and the
// caller has width <= blockDim.x)
template <int NC>
__device__ __forceinline__ int bt_nc(int NP) { return NC == 1 ? 1 : (NP + blockDim.x - 1) / blockDim.x; }

// K sums over the pairwise tree of `width` lanes at once, each bit for bit
// bayes.py::tree_sum: level s = width / 2, ..., 1 adds lane i + s to lane i.
// Lane l = threadIdx.x + c blockDim.x holds lanes[c][k] (zeros past the row);
// blockDim.x is a power of two >= 128 and width <= NC x blockDim.x. Levels
// s >= blockDim.x add chunk c + s / blockDim.x to chunk c in registers; the
// lanes left, w = min(width, blockDim.x), go to shared memory (buf: K x
// blockDim.x floats, k-major), levels w / 2 .. 128 add in place there; then
// every warp takes levels 64 and 32 from the 128 lanes left and 16 .. 1 by
// __shfl_down_sync, so every thread holds the sums in out[] with no barrier
// after the last level. A later call may reuse buf once a barrier lies
// between (bayes_tail alternates two buffers).
template <int NC, int K>
__device__ __forceinline__ void tree_sums(const float (&lanes)[NC][K], float* buf, int width, float (&out)[K]) {
  const int t = threadIdx.x, T = blockDim.x, l = t & 31;
  float v[NC][K];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
#pragma unroll
    for (int k = 0; k < K; ++k) v[c][k] = lanes[c][k];
  }
#pragma unroll
  for (int h = NC / 2; h >= 1; h >>= 1) {
    if (width >= 2 * h * T) {
#pragma unroll
      for (int c = 0; c < h; ++c) {
#pragma unroll
        for (int k = 0; k < K; ++k) v[c][k] = v[c][k] + v[c + h][k];
      }
    }
  }
  const int w = min(width, T);
  if (t < w) {
#pragma unroll
    for (int k = 0; k < K; ++k) buf[k * T + t] = v[0][k];
  }
  __syncthreads();
  for (int s = w / 2; s >= 128; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < K; ++k) buf[k * T + t] = buf[k * T + t] + buf[k * T + t + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float* b = buf + k * T;
    float x = (b[l] + b[l + 64]) + (b[l + 32] + b[l + 96]);
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) x = x + __shfl_down_sync(0xffffffffu, x, s);
    out[k] = __shfl_sync(0xffffffffu, x, 0);
  }
}

// floats of buf that bayes_tail<NC> takes for a block of T threads
#define BT_TREE_FLOATS(T) (5 * (T))

// in[c]: this thread's particles; block-uniform: making, pmask,
// match_attempts; buf: BT_TREE_FLOATS(blockDim.x) floats of shared memory.
// Writes each particle's prob_f and palive_f and returns the block-uniform
// scalars. Three passes of tree_sums: (total, n_alive), total2, (n_alive_f,
// mean, exp2, n_over), the first and the last in buf, the second past it.
template <int NC>
__device__ inline BayesResult bayes_tail(const BayesLane in[NC], int nc, bool making, bool pmask,
                                         float match_attempts, const BayesConsts& bc, float* buf, int width,
                                         float prob_f_out[NC], bool palive_f_out[NC]) {
  float prob1[NC], v1[NC][2], s1[2];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    prob1[c] = 0.0f;
    v1[c][0] = v1[c][1] = 0.0f;
    if (c < nc) {
      prob1[c] = bt_prob1(in[c], making);
      v1[c][0] = in[c].palive ? prob1[c] : 0.0f;
      v1[c][1] = in[c].palive ? 1.0f : 0.0f;
    }
  }
  tree_sums<NC, 2>(v1, buf, width, s1);
  SB_MARK(7);
  const float total = s1[0], n_alive = s1[1];
  const bool all_zero = making && total == 0.0f;
  const float safe_total = total > 0.0f ? total : 1.0f;
  const float thresh = bc.prune_prob_thresh / fmaxf(n_alive, 1.0f);

  bool keep[NC];
  float v2[NC][1], s2[1];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    keep[c] = false;
    v2[c][0] = 0.0f;
    if (c < nc) v2[c][0] = bt_prob_k(prob1[c], in[c].palive, making, safe_total, thresh, &keep[c]);
  }
  tree_sums<NC, 1>(v2, buf + 4 * blockDim.x, width, s2);
  SB_MARK(8);
  const float total2 = s2[0];

  float v3[NC][4], s3[4];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    v3[c][0] = v3[c][1] = v3[c][2] = v3[c][3] = 0.0f;
    if (c < nc) {
      prob_f_out[c] = bt_prob_f(v2[c][0], making, total2);
      palive_f_out[c] = bt_palive_f(keep[c], in[c].palive, making);
      v3[c][0] = palive_f_out[c] ? 1.0f : 0.0f;
      v3[c][1] = in[c].lam * prob_f_out[c];
      v3[c][2] = in[c].lam * in[c].lam * prob_f_out[c];
      v3[c][3] = in[c].p_over ? 1.0f : 0.0f;
    }
  }
  tree_sums<NC, 4>(v3, buf, width, s3);
  SB_MARK(12);
  return bt_result(s3[1], s3[2], all_zero, s3[0], s3[3], making, pmask, match_attempts, bc);
}

// the pairwise tree over buf[0 .. width) (filled by the caller, who ends
// with __syncthreads): width / 2, ..., 1, each level adding lane i + s to
// lane i, any number of lanes a thread
__device__ inline float bt_tree_levels(float* buf, int width) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int s = width / 2; s > 0; s >>= 1) {
    for (int i = t; i < s; i += nt) buf[i] = buf[i] + buf[i + s];
    __syncthreads();
  }
  const float r = buf[0];
  __syncthreads();
  return r;
}

// lane(l): particle l's BayesLane, rebuilt from global memory on each call
// (the same values every time); buf: width floats of global memory;
// prob_f_out / palive_f_out: the row's [NP] outputs, which hold the
// per-particle intermediates between the sums (each thread its own
// particles). The same operations and trees as bayes_tail<NC>.
template <typename LaneFn>
__device__ inline BayesResult bayes_tail_wide(LaneFn lane, int NP, bool making, bool pmask, float match_attempts,
                                              const BayesConsts& bc, float* buf, int width, float* prob_f_out,
                                              uint8_t* palive_f_out) {
  const int t = threadIdx.x, nt = blockDim.x;
  for (int l = t; l < width; l += nt) {
    float v = 0.0f;
    if (l < NP) {
      const BayesLane q = lane(l);
      const float p1 = bt_prob1(q, making);
      prob_f_out[l] = p1;
      v = q.palive ? p1 : 0.0f;
    }
    buf[l] = v;
  }
  __syncthreads();
  const float total = bt_tree_levels(buf, width);
  const bool all_zero = making && total == 0.0f;
  const float safe_total = total > 0.0f ? total : 1.0f;

  for (int l = t; l < width; l += nt) buf[l] = (l < NP && lane(l).palive) ? 1.0f : 0.0f;
  __syncthreads();
  const float n_alive = bt_tree_levels(buf, width);
  const float thresh = bc.prune_prob_thresh / fmaxf(n_alive, 1.0f);
  for (int l = t; l < width; l += nt) {
    float v = 0.0f;
    if (l < NP) {
      const bool palive = lane(l).palive;
      bool keep;
      v = bt_prob_k(prob_f_out[l], palive, making, safe_total, thresh, &keep);
      prob_f_out[l] = v;
      palive_f_out[l] = bt_palive_f(keep, palive, making);
    }
    buf[l] = v;
  }
  __syncthreads();
  const float total2 = bt_tree_levels(buf, width);
  for (int l = t; l < width; l += nt) {
    float v = 0.0f;
    if (l < NP) {
      prob_f_out[l] = bt_prob_f(prob_f_out[l], making, total2);
      v = palive_f_out[l] ? 1.0f : 0.0f;
    }
    buf[l] = v;
  }
  __syncthreads();
  const float n_alive_f = bt_tree_levels(buf, width);

  for (int l = t; l < width; l += nt) buf[l] = l < NP ? lane(l).lam * prob_f_out[l] : 0.0f;
  __syncthreads();
  const float mean = bt_tree_levels(buf, width);
  for (int l = t; l < width; l += nt) {
    float v = 0.0f;
    if (l < NP) {
      const float lam = lane(l).lam;
      v = lam * lam * prob_f_out[l];
    }
    buf[l] = v;
  }
  __syncthreads();
  const float exp2 = bt_tree_levels(buf, width);
  for (int l = t; l < width; l += nt) buf[l] = (l < NP && lane(l).p_over) ? 1.0f : 0.0f;
  __syncthreads();
  const float n_over = bt_tree_levels(buf, width);
  return bt_result(mean, exp2, all_zero, n_alive_f, n_over, making, pmask, match_attempts, bc);
}
