// The NSSD scoring and selection of one elliptical search window.
//
// Shared by K2 (k2_kernel: the window is read from the frame) and K8
// (k8_kernel: the window was gathered by the caller), both in search.cu;
// scenelib2_torch/kernels/search.py holds their plain versions
// (search_plain, search_windows_plain). The NSSD formula is
// pallas_score_map.py::nssd_corr_f32 (improc.cpp:55-134) in the plain
// versions' operation order (built with -fmad=false); the integer sums are
// exact in any order.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct K2Params {
  int H, W, B, side_v, side_u, per_lane;
  float no_sigma, no_sigma2, corr_thresh2, corr_sigma_thresh;
};

__device__ __forceinline__ float block_min(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_max(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -1;
    for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// Scores candidate (r, cc) of the window: false when the mask rejects it,
// else true with its NSSD in *corr (nssd_corr_f32, improc.cpp:55-134).
__device__ __forceinline__ bool score_cell(const float* win, const float* patch, int r, int cc,
                                           int wu, int u0, int v0, int uc, int vc, float a,
                                           float b, float c, float halfwidth, float halfheight,
                                           float sg0, float sg0sq, const K2Params& p,
                                           float* corr_out) {
  const int B = p.B, half = (B - 1) / 2;
  const int uu = u0 + cc, vv = v0 + r;
  const float urel = (float)(uu - uc), vrel = (float)(vv - vc);
  const bool box = fabsf(urel) <= halfwidth && fabsf(vrel) <= halfheight;
  const bool ellipse = a * urel * urel + 2.0f * b * urel * vrel + c * vrel * vrel < p.no_sigma2;
  const bool centre_ok = uu >= half && uu <= p.W - 1 - half && vv >= half && vv <= p.H - 1 - half;
  if (!(box && ellipse && centre_ok)) return false;
  float sg1 = 0.0f, sg1sq = 0.0f, cross = 0.0f;  // integer-valued: exact in any order
  for (int dy = 0; dy < B; ++dy) {
    const float* row = win + (r + dy) * wu + cc;
    const float* prow = patch + dy * B;
    for (int dx = 0; dx < B; ++dx) {
      const float w = row[dx];
      sg1 = sg1 + w;
      sg1sq = sg1sq + w * w;
      cross = cross + prow[dx] * w;
    }
  }
  const float n = (float)(B * B);
  const float g0bar = sg0 / n;
  const float g1bar = sg1 / n;
  const float varg0 = sg0sq / n - g0bar * g0bar;
  const float varg1 = sg1sq / n - g1bar * g1bar;
  const float sd0 = sqrtf(varg0);
  const float sd1 = sqrtf(varg1);
  if (!(sd1 >= p.corr_sigma_thresh && sd0 >= p.corr_sigma_thresh)) return false;
  const float v1s = varg1 == 0.0f ? 1.0f : varg1;
  const float s1 = sqrtf(v1s);
  const float v0s = varg0 == 0.0f ? 1.0f : varg0;
  const float s0 = sqrtf(v0s);
  const float kk = g0bar / s0 - g1bar / s1;
  const float corr = (sg0sq / v0s + sg1sq / v1s + n * (kk * kk) - cross * 2.0f / (s0 * s1)
                      - sg0 * 2.0f * kk / s0 + sg1 * 2.0f * kk / s1) / n;
  const bool both_zero = sd0 == 0.0f && sd1 == 0.0f;
  *corr_out = (sd0 != 0.0f && sd1 != 0.0f) ? corr : (both_zero ? 0.0f : 1.0f);
  return true;
}


// One block scores every candidate centre of its window (win [wv][wu] and
// patch [B*B] in shared memory) and writes the masked minimum, the largest
// u*H + v key among the cells at the minimum (the reference keeps the LAST
// tie in u-outer / v-inner scan order), found and overflow for feature k.
__device__ __forceinline__ void search_select(const float* win, const float* patch, float sg0,
                                              float sg0sq, int k, int u0, int v0, int uc, int vc,
                                              float a, float b, float c, bool act, const K2Params& p,
                                              float* redf, int* redi, uint8_t* found, int* uo, int* vo,
                                              float* best_o, uint8_t* over_o) {
  const int B = p.B;
  const int sv = p.side_v, su = p.side_u;
  const int wu = su + B - 1;
  const float halfwidth = floorf(p.no_sigma / sqrtf(a - b * b / c));
  const float halfheight = floorf(p.no_sigma / sqrtf(c - b * b / a));

  float vbest = 1e6f;  // the value of a masked-out cell
  for (int e = threadIdx.x; e < sv * su; e += blockDim.x) {
    const int r = e / su, cc = e - r * su;
    float corr;
    if (score_cell(win, patch, r, cc, wu, u0, v0, uc, vc, a, b, c, halfwidth, halfheight, sg0,
                   sg0sq, p, &corr))
      vbest = fminf(vbest, corr);
  }
  const float best = block_min(vbest, redf);

  // the largest (u, v) key among admitted cells at the minimum; rescoring
  // the few admitted cells keeps no per-cell state
  int kbest = -1;
  if (best < 1e6f) {
    for (int e = threadIdx.x; e < sv * su; e += blockDim.x) {
      const int r = e / su, cc = e - r * su;
      float corr;
      if (score_cell(win, patch, r, cc, wu, u0, v0, uc, vc, a, b, c, halfwidth, halfheight, sg0,
                     sg0sq, p, &corr) && corr == best)
        kbest = max(kbest, (u0 + cc) * p.H + (v0 + r));
    }
  }
  kbest = block_max(kbest, redi);

  if (threadIdx.x == 0) {
    best_o[k] = best;
    uo[k] = kbest >= 0 ? kbest / p.H : -1;
    vo[k] = kbest >= 0 ? kbest % p.H : -1;
    found[k] = act && best <= p.corr_thresh2;
    over_o[k] = act && (halfwidth > (float)(su / 2) || halfheight > (float)(sv / 2));
  }
}
