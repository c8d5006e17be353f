// The particle Bayes tail, block-level.
//
// The CUDA form of scenelib2_torch/kernels/bayes.py::bayes_tail, which ports
// scenelib2_tpu/kernels/pallas_bayes.py::_bayes_tail. Each thread holds the
// particles t, t + blockDim.x, ... (nc = bt_nc<NC>(NP) of them, at most the
// template's NC), one BayesLane each; particles at or beyond NP hold zeros
// and false. Every thread of the block calls it, since the sums are block
// reductions: the pairwise tree over `width` lanes (bayes.py::tree_width:
// the TPU kernel's padded row of max(128, NP rounded up to 128) lanes,
// zero-padded on to a power of two) that the twin's tree_sum takes: width / 2,
// ..., 1, each level adding lane i + s to lane i. The kernels are built for
// NC = 1 (one particle a thread, width <= blockDim.x: NP <= 1,024) and NC =
// BT_MAX_CHUNKS, and pick one at launch from NP, so that rows of up to 1,024
// particles hold no per-thread arrays. Included by search_bayes.cu (K4, K11)
// and bayes.cu (K12).
#pragma once

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
    const BayesLane& q = in[c];
    const float nu_u = q.zu - q.hu, nu_v = q.zv - q.hv;
    const float quad = q.a * nu_u * nu_u + 2.0f * q.b * nu_u * nu_v + q.c * nu_v * nu_v;
    const float gauss = (1.0f / sqrtf(6.283185307179586f * q.det)) * expf(-0.5f * quad);
    const float likelihood = q.found ? gauss : (q.p_over ? 1.0f : 0.0f);
    const bool upd = making && q.palive;
    prob1[c] = upd ? q.prob * likelihood : q.prob;
    v[c] = q.palive ? prob1[c] : 0.0f;
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
  for (int c = 0; c < NC && c < nc; ++c) {
    const float prob_n = making ? prob1[c] / safe_total : prob1[c];
    keep[c] = in[c].palive && !(making && prob_n < thresh);
    prob_k[c] = keep[c] ? prob_n : 0.0f;
  }
  const float total2 = tree_sum<NC>(prob_k, nc, buf, width);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) {
    prob_f_out[c] = (making && total2 > 0.0f) ? prob_k[c] / (total2 > 0.0f ? total2 : 1.0f) : prob_k[c];
    palive_f_out[c] = (making && keep[c]) || (!making && in[c].palive);
    v[c] = palive_f_out[c] ? 1.0f : 0.0f;
  }
  const float n_alive_f = tree_sum<NC>(v, nc, buf, width);

#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].lam * prob_f_out[c];
  const float mean = tree_sum<NC>(v, nc, buf, width);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].lam * in[c].lam * prob_f_out[c];
  const float exp2 = tree_sum<NC>(v, nc, buf, width);
  const float cov = exp2 - mean * mean;
  const float ratio = sqrtf(cov) / mean;
  const bool convert = making && !all_zero && ratio < bc.sd_depth_ratio && n_alive_f > bc.min_particles;
  const bool sell_by = pmask && !convert &&
                       (match_attempts > bc.erase_partial_after_attempts || n_alive_f <= bc.min_particles);
#pragma unroll
  for (int c = 0; c < NC && c < nc; ++c) v[c] = in[c].p_over ? 1.0f : 0.0f;
  const float n_over = tree_sum<NC>(v, nc, buf, width);
  BayesResult r;
  r.mean = mean;
  r.cov = cov;
  r.convert = convert;
  r.kill = all_zero || sell_by;
  r.n_over = (int)n_over;
  return r;
}
