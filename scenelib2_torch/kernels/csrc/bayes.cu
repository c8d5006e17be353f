// K12: the particle Bayes update of the partial features' rows.
//
// Replaces scenelib2_tpu/kernels/pallas_bayes.py (pallas_bayes_update /
// _bayes_kernel, pallas_call at pallas_bayes.py:246): likelihood -> Bayes ->
// renormalise -> prune -> renormalise -> lambda moments -> convert / kill
// decisions, one row of particles at a time (reference monoslam.cpp:1446-1517,
// feature_init_info.cpp:99-174). The tail is bayes_tail.cuh, the device code
// that K4 and K11 (search_bayes.cu) end with, so on the same row K12 decides
// and rounds exactly as they do. The plain PyTorch twin is
// scenelib2_torch/kernels/bayes.py::bayes_update_plain.
//
// The row's particle geometry (hu, hv, S^-1 entries a, b, c, det) comes in
// one of two forms, as the TPU kernel takes it: separate arrays hpi [F, NP, 2],
// sinv [F, NP, 2, 2], dets [F, NP] (13 rows: the batch route with
// batch_pallas=False), or K10's prediction rows [F, 8, pred_w] whose first six
// rows are HU, HV, S00, S01, S11, DET (7 + 8 rows: the route with
// SCENELIB2_BATCH_SB=0). Lanes at or beyond NP hold zeros and false (and, in
// the prediction-row form, K10's padding lanes, which no sum reads).
//
// Bound on an H100 at 64 rows x 100 particles: ~0.2 MB in and out and ~10 k
// operations a row: well under a microsecond; the launch dominates. Design:
// one block of `lanes` threads (128, or 256 above 128 particles) per row, one
// particle a thread; the sums are bayes_tail.cuh's fixed pairwise trees over
// the padded row in shared memory.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bayes_tail.cuh"

struct K12Params {
  int NP, lanes, pred_w;
  float prune_prob_thresh, sd_depth_ratio, min_particles, erase_partial_after_attempts;
};

__global__ void __launch_bounds__(BT_MAX_LANES)
k12_kernel(const float* __restrict__ prob, const float* __restrict__ lam,
           const uint8_t* __restrict__ palive, const uint8_t* __restrict__ found_in,
           const uint8_t* __restrict__ p_over_in, const float* __restrict__ z,
           const float* __restrict__ hpi, const float* __restrict__ sinv,
           const float* __restrict__ dets, const float* __restrict__ pred,
           const uint8_t* __restrict__ making_p, const uint8_t* __restrict__ pmask_p,
           const int* __restrict__ ma_p, float* __restrict__ prob_o, uint8_t* __restrict__ palive_o,
           float* __restrict__ mean_o, float* __restrict__ cov_o, uint8_t* __restrict__ convert_o,
           uint8_t* __restrict__ kill_o, int* __restrict__ nover_o, K12Params p) {
  __shared__ float buf[BT_MAX_LANES];
  const int f = blockIdx.x, t = threadIdx.x, NP = p.NP;
  const bool valid = t < NP;
  const size_t i = (size_t)f * NP + t;
  float prob_in = 0.0f, lam_in = 0.0f, zu = 0.0f, zv = 0.0f;
  bool alive = false, found = false, over = false;
  float g[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // hu, hv, a, b, c, det
  if (valid) {
    prob_in = prob[i];
    lam_in = lam[i];
    alive = palive[i] != 0;
    found = found_in[i] != 0;
    over = p_over_in[i] != 0;
    zu = z[2 * i];
    zv = z[2 * i + 1];
  }
  if (pred != nullptr) {
    if (t < p.pred_w)
      for (int r = 0; r < 6; ++r) g[r] = pred[((size_t)f * 8 + r) * p.pred_w + t];
  } else if (valid) {
    g[0] = hpi[2 * i];
    g[1] = hpi[2 * i + 1];
    g[2] = sinv[4 * i];
    g[3] = sinv[4 * i + 1];
    g[4] = sinv[4 * i + 3];
    g[5] = dets[i];
  }
  const BayesConsts bc = {p.prune_prob_thresh, p.sd_depth_ratio, p.min_particles,
                          p.erase_partial_after_attempts};
  float prob_f;
  bool alive_f;
  const BayesResult res = bayes_tail(prob_in, lam_in, alive, found, over, zu, zv, g[0], g[1], g[2], g[3],
                                     g[4], g[5], making_p[f] != 0, pmask_p[f] != 0, (float)ma_p[f], bc,
                                     buf, p.lanes, &prob_f, &alive_f);
  if (valid) {
    prob_o[i] = prob_f;
    palive_o[i] = alive_f;
  }
  if (t == 0) {
    mean_o[f] = res.mean;
    cov_o[f] = res.cov;
    convert_o[f] = res.convert;
    kill_o[f] = res.kill;
    nover_o[f] = res.n_over;
  }
}

// F rows; pred == nullptr takes the geometry from hpi / sinv / dets, else
// from the prediction rows (hpi, sinv, dets unused)
extern "C" int k12_bayes(const float* prob, const float* lam, const uint8_t* palive, const uint8_t* found,
                         const uint8_t* p_over, const float* z, const float* hpi, const float* sinv,
                         const float* dets, const float* pred, const uint8_t* making, const uint8_t* pmask,
                         const int* match_attempts, float* prob_o, uint8_t* palive_o, float* mean,
                         float* cov, uint8_t* convert, uint8_t* kill, int* n_over, int F,
                         const K12Params* p, void* stream) {
  if (p->NP > p->lanes || p->lanes > BT_MAX_LANES || p->lanes % 32 != 0) return (int)cudaErrorInvalidValue;
  if (pred != nullptr && p->pred_w < p->NP) return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  k12_kernel<<<F, p->lanes, 0, (cudaStream_t)stream>>>(prob, lam, palive, found, p_over, z, hpi, sinv, dets,
                                                       pred, making, pmask, match_attempts, prob_o, palive_o,
                                                       mean, cov, convert, kill, n_over, *p);
  return (int)cudaGetLastError();
}
