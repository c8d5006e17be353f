// The particle Bayes tail, block-level.
//
// The CUDA form of scenelib2_torch/kernels/bayes.py::bayes_tail, which ports
// scenelib2_tpu/kernels/pallas_bayes.py::_bayes_tail, in two forms with the
// same per-particle operations (bt_* below) and the same trees.
// bayes_tail<NC>: each thread holds the particles t, t + blockDim.x, ...
// (nc = bt_nc<NC>(NP) of them, at most the template's NC), one BayesLane
// each; particles at or beyond NP hold zeros and false. Every thread of the block calls it, since the sums are block
// reductions: the pairwise tree over `width` lanes (bayes.py::tree_width:
// the TPU kernel's padded row of max(128, NP rounded up to 128) lanes,
// zero-padded on to a power of two) that the twin's tree_sum takes: width / 2,
// ..., 1, each level adding lane i + s to lane i. The kernels are built for
// NC = 1 (one particle a thread, width <= blockDim.x: NP <= 1,024) and NC =
// BT_MAX_CHUNKS, and pick one at launch from NP, so that rows of up to 1,024
// particles hold no per-thread arrays. bayes_tail_wide: rows of more than
// BT_MAX_CHUNKS x blockDim.x particles; threads loop over as many chunks as
// the row needs, a callback rebuilds each particle's BayesLane from global
// memory, and the tree and the intermediates live in global memory (the
// tree buffer in a workspace, the intermediates in the row's outputs).
// Included by search_bayes.cu (K4, K11) and bayes.cu (K12).
#pragma once

#include <stdint.h>

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

// sum over the tree of `width` lanes of the values v[c] of particle
// threadIdx.x + c blockDim.x (c < nc); buf: width floats of shared memory
template <int NC>
__device__ inline float tree_sum(const float v[NC], int nc, float* buf, int width) {
  const int t = threadIdx.x, nt = blockDim.x;
  if (NC == 1) {
    if (t < width) buf[t] = v[0];
    __syncthreads();
    for (int s = width / 2; s > 0; s >>= 1) {
      if (t < s) buf[t] = buf[t] + buf[t + s];
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = t + c * nt;
      if (c < nc && l < width) buf[l] = v[c];
    }
    for (int l = nc * nt + t; l < width; l += nt) buf[l] = 0.0f;
    __syncthreads();
    for (int s = width / 2; s > 0; s >>= 1) {
      for (int i = t; i < s; i += nt) buf[i] = buf[i] + buf[i + s];
      __syncthreads();
    }
  }
  const float r = buf[0];
  __syncthreads();
  return r;
}

// in[c]: this thread's particles; block-uniform: making, pmask,
// match_attempts. Writes each particle's prob_f and palive_f and returns the
// block-uniform scalars.
template <int NC>
__device__ inline BayesResult bayes_tail(const BayesLane in[NC], int nc, bool making, bool pmask,
                                         float match_attempts, const BayesConsts& bc, float* buf, int width,
                                         float prob_f_out[NC], bool palive_f_out[NC]) {
  float prob1[NC], v[NC];
  // every per-particle loop runs over the thread's nc chunks only: tree_sum
  // reads v[c] for c < nc, the callers read prob_f / palive_f there
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) {
    prob1[c] = bt_prob1(in[c], making);
    v[c] = in[c].palive ? prob1[c] : 0.0f;
  }
  const float total = tree_sum<NC>(v, nc, buf, width);
  const bool all_zero = making && total == 0.0f;
  const float safe_total = total > 0.0f ? total : 1.0f;

#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].palive ? 1.0f : 0.0f;
  const float n_alive = tree_sum<NC>(v, nc, buf, width);
  const float thresh = bc.prune_prob_thresh / fmaxf(n_alive, 1.0f);
  bool keep[NC];
  float prob_k[NC];
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c)
    prob_k[c] = bt_prob_k(prob1[c], in[c].palive, making, safe_total, thresh, &keep[c]);
  const float total2 = tree_sum<NC>(prob_k, nc, buf, width);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) {
    prob_f_out[c] = bt_prob_f(prob_k[c], making, total2);
    palive_f_out[c] = bt_palive_f(keep[c], in[c].palive, making);
    v[c] = palive_f_out[c] ? 1.0f : 0.0f;
  }
  const float n_alive_f = tree_sum<NC>(v, nc, buf, width);

#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].lam * prob_f_out[c];
  const float mean = tree_sum<NC>(v, nc, buf, width);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].lam * in[c].lam * prob_f_out[c];
  const float exp2 = tree_sum<NC>(v, nc, buf, width);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].p_over ? 1.0f : 0.0f;
  const float n_over = tree_sum<NC>(v, nc, buf, width);
  return bt_result(mean, exp2, all_zero, n_alive_f, n_over, making, pmask, match_attempts, bc);
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
