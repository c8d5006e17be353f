// The particle Bayes tail, block-level.
//
// The CUDA form of scenelib2_torch/kernels/bayes.py::bayes_tail, which ports
// scenelib2_tpu/kernels/pallas_bayes.py::_bayes_tail. Threads 0..lanes-1
// hold one particle lane each, lanes = max(128, NP rounded up to 128) (the
// TPU kernel's padded row: 128 up to 128 particles, 256 up to 256; lanes at
// or beyond NP hold zeros and false); every thread of the block calls it,
// since the sums are block reductions: the pairwise tree over the lanes
// (lanes / 2, ..., 1) that the twin's tree_sum takes. Included by
// search_bayes.cu (K4, K11).
#pragma once

#define BT_MAX_LANES 256

struct BayesConsts {
  float prune_prob_thresh, sd_depth_ratio, min_particles, erase_partial_after_attempts;
};

struct BayesResult {
  float mean, cov;
  bool convert, kill;
  int n_over;
};

// sum over the lanes (128 or 256); buf: BT_MAX_LANES floats of shared memory
__device__ inline float tree_sum(float v, float* buf, int lanes) {
  const int t = threadIdx.x;
  if (t < lanes) buf[t] = v;
  __syncthreads();
  for (int s = lanes / 2; s > 0; s >>= 1) {
    if (t < s) buf[t] = buf[t] + buf[t + s];
    __syncthreads();
  }
  const float r = buf[0];
  __syncthreads();
  return r;
}

// Per lane: prob, lam, palive, found, p_over, zu, zv, hu, hv, a, b, c, det;
// block-uniform: making, pmask, match_attempts. Returns the lane's prob_f and
// palive_f through the pointers and the block-uniform scalars.
__device__ inline BayesResult bayes_tail(float prob, float lam, bool palive, bool found, bool p_over,
                                         float zu, float zv, float hu, float hv, float a, float b,
                                         float c, float det, bool making, bool pmask,
                                         float match_attempts, const BayesConsts& bc, float* buf,
                                         int lanes, float* prob_f_out, bool* palive_f_out) {
  const float nu_u = zu - hu, nu_v = zv - hv;
  const float quad = a * nu_u * nu_u + 2.0f * b * nu_u * nu_v + c * nu_v * nu_v;
  const float gauss = (1.0f / sqrtf(6.283185307179586f * det)) * expf(-0.5f * quad);
  const float likelihood = found ? gauss : (p_over ? 1.0f : 0.0f);
  const bool upd = making && palive;
  const float prob1 = upd ? prob * likelihood : prob;

  const float total = tree_sum(palive ? prob1 : 0.0f, buf, lanes);
  const bool all_zero = making && total == 0.0f;
  const float safe_total = total > 0.0f ? total : 1.0f;
  const float prob_n = making ? prob1 / safe_total : prob1;

  const float n_alive = tree_sum(palive ? 1.0f : 0.0f, buf, lanes);
  const float thresh = bc.prune_prob_thresh / fmaxf(n_alive, 1.0f);
  const bool keep = palive && !(making && prob_n < thresh);
  const float prob_k = keep ? prob_n : 0.0f;
  const float total2 = tree_sum(prob_k, buf, lanes);
  const float prob_f = (making && total2 > 0.0f) ? prob_k / (total2 > 0.0f ? total2 : 1.0f) : prob_k;
  const bool palive_f = (making && keep) || (!making && palive);
  const float n_alive_f = tree_sum(palive_f ? 1.0f : 0.0f, buf, lanes);

  const float mean = tree_sum(lam * prob_f, buf, lanes);
  const float exp2 = tree_sum(lam * lam * prob_f, buf, lanes);
  const float cov = exp2 - mean * mean;
  const float ratio = sqrtf(cov) / mean;
  const bool convert = making && !all_zero && ratio < bc.sd_depth_ratio && n_alive_f > bc.min_particles;
  const bool sell_by = pmask && !convert &&
                       (match_attempts > bc.erase_partial_after_attempts || n_alive_f <= bc.min_particles);
  const float n_over = tree_sum(p_over ? 1.0f : 0.0f, buf, lanes);
  *prob_f_out = prob_f;
  *palive_f_out = palive_f;
  BayesResult r;
  r.mean = mean;
  r.cov = cov;
  r.convert = convert;
  r.kill = all_zero || sell_by;
  r.n_over = (int)n_over;
  return r;
}
