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
// SCENELIB2_BATCH_SB=0). Particles at or beyond NP hold zeros and false
// (K10's padding lanes are not read).
//
// Bound on an H100 at 64 rows x 100 particles: ~0.2 MB in and out and ~10 k
// operations a row: well under a microsecond; the launch dominates. Design:
// one block per row; up to 1,024 particles, `width` threads (the tree's
// lanes) of one particle each (NC = 1), above it 1,024 threads striding over
// the particles, up to bayes_tail.cuh's BT_MAX_CHUNKS each (NC = 4); the
// sums are bayes_tail.cuh's fixed pairwise trees over `width` lanes in
// dynamic shared memory, in three passes of sums side by side. Rows of more particles (NC = 0) take
// bayes_tail_wide: 1,024 threads loop over the row, the tree in a global
// workspace that the wrapper allocates, the same trees.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bayes_tail.cuh"

#define K12_MAX_THREADS 1024

struct K12Params {
  int NP, width, pred_w;
  float prune_prob_thresh, sd_depth_ratio, min_particles, erase_partial_after_attempts;
};

// particle l of row f, with its geometry from either form
__device__ __forceinline__ BayesLane k12_lane(const float* __restrict__ prob, const float* __restrict__ lam,
                                              const uint8_t* __restrict__ palive,
                                              const uint8_t* __restrict__ found_in,
                                              const uint8_t* __restrict__ p_over_in, const float* __restrict__ z,
                                              const float* __restrict__ hpi, const float* __restrict__ sinv,
                                              const float* __restrict__ dets, const float* __restrict__ pred,
                                              int f, int l, const K12Params& p) {
  BayesLane q;
  const size_t i = (size_t)f * p.NP + l;
  q.prob = prob[i];
  q.lam = lam[i];
  q.palive = palive[i] != 0;
  q.found = found_in[i] != 0;
  q.p_over = p_over_in[i] != 0;
  q.zu = z[2 * i];
  q.zv = z[2 * i + 1];
  if (pred != nullptr) {
    const float* g = pred + (size_t)f * 8 * p.pred_w + l;
    q.hu = g[0];
    q.hv = g[p.pred_w];
    q.a = g[2 * p.pred_w];
    q.b = g[3 * p.pred_w];
    q.c = g[4 * p.pred_w];
    q.det = g[5 * p.pred_w];
  } else {
    q.hu = hpi[2 * i];
    q.hv = hpi[2 * i + 1];
    q.a = sinv[4 * i];
    q.b = sinv[4 * i + 1];
    q.c = sinv[4 * i + 3];
    q.det = dets[i];
  }
  return q;
}

// NC = 1 or BT_MAX_CHUNKS: particles in registers, the tree in dynamic shared
// memory; NC = 0: any NP, bayes_tail_wide, the tree in wide_ws [F][width]
template <int NC>
__global__ void __launch_bounds__(K12_MAX_THREADS)
k12_kernel(const float* __restrict__ prob, const float* __restrict__ lam,
           const uint8_t* __restrict__ palive, const uint8_t* __restrict__ found_in,
           const uint8_t* __restrict__ p_over_in, const float* __restrict__ z,
           const float* __restrict__ hpi, const float* __restrict__ sinv,
           const float* __restrict__ dets, const float* __restrict__ pred,
           const uint8_t* __restrict__ making_p, const uint8_t* __restrict__ pmask_p,
           const int* __restrict__ ma_p, float* __restrict__ prob_o, uint8_t* __restrict__ palive_o,
           float* __restrict__ mean_o, float* __restrict__ cov_o, uint8_t* __restrict__ convert_o,
           uint8_t* __restrict__ kill_o, int* __restrict__ nover_o, float* wide_ws, K12Params p) {
  extern __shared__ float buf[];  // BT_TREE_FLOATS(blockDim.x) (NC > 0)
  const int f = blockIdx.x, t = threadIdx.x, NP = p.NP;
  const BayesConsts bc = {p.prune_prob_thresh, p.sd_depth_ratio, p.min_particles,
                          p.erase_partial_after_attempts};
  BayesResult res;
  if constexpr (NC == 0) {
    auto lane = [&](int l) {
      return k12_lane(prob, lam, palive, found_in, p_over_in, z, hpi, sinv, dets, pred, f, l, p);
    };
    res = bayes_tail_wide(lane, NP, making_p[f] != 0, pmask_p[f] != 0, (float)ma_p[f], bc,
                          wide_ws + (size_t)f * p.width, p.width, prob_o + (size_t)f * NP, palive_o + (size_t)f * NP);
  } else {
    const int nc = bt_nc<NC>(NP);
    BayesLane in[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = t + c * blockDim.x;
      BayesLane q = {0.0f, 0.0f, false, false, false, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      if (c < nc && l < NP) q = k12_lane(prob, lam, palive, found_in, p_over_in, z, hpi, sinv, dets, pred, f, l, p);
      in[c] = q;
    }
    float prob_f[NC];
    bool alive_f[NC];
    res = bayes_tail<NC>(in, nc, making_p[f] != 0, pmask_p[f] != 0, (float)ma_p[f], bc, buf, p.width, prob_f,
                         alive_f);
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int l = t + c * blockDim.x;
      if (c < nc && l < NP) {
        prob_o[(size_t)f * NP + l] = prob_f[c];
        palive_o[(size_t)f * NP + l] = alive_f[c];
      }
    }
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
// from the prediction rows (hpi, sinv, dets unused). Rows of more than
// BT_MAX_CHUNKS x 1,024 particles need wide_ws, F x width floats (else
// unused).
extern "C" int k12_bayes(const float* prob, const float* lam, const uint8_t* palive, const uint8_t* found,
                         const uint8_t* p_over, const float* z, const float* hpi, const float* sinv,
                         const float* dets, const float* pred, const uint8_t* making, const uint8_t* pmask,
                         const int* match_attempts, float* prob_o, uint8_t* palive_o, float* mean,
                         float* cov, uint8_t* convert, uint8_t* kill, int* n_over, float* wide_ws, int F,
                         const K12Params* p, void* stream) {
  const bool one = p->width <= K12_MAX_THREADS;  // NC = 1: a thread per lane of the tree
  const bool wide = p->NP > BT_MAX_CHUNKS * K12_MAX_THREADS;
  const int threads = one ? p->width : K12_MAX_THREADS;
  if (p->NP < 1 || p->width < p->NP || p->width < 32 || (p->width & (p->width - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  if (pred != nullptr && p->pred_w < p->NP) return (int)cudaErrorInvalidValue;
  if (wide && wide_ws == nullptr) return (int)cudaErrorInvalidValue;
  if (F == 0) return 0;
  const size_t smem = wide ? 0 : sizeof(float) * (size_t)BT_TREE_FLOATS(threads);
  auto kernel = wide ? k12_kernel<0> : one ? k12_kernel<1> : k12_kernel<BT_MAX_CHUNKS>;
  kernel<<<F, threads, smem, (cudaStream_t)stream>>>(prob, lam, palive, found, p_over, z, hpi, sinv, dets, pred,
                                                     making, pmask, match_attempts, prob_o, palive_o, mean, cov,
                                                     convert, kill, n_over, wide_ws, *p);
  return (int)cudaGetLastError();
}
