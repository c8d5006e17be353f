// NSSD score from exact integer sums, and its penalized form.
//
// The CUDA form of scenelib2_torch/kernels/search.py::nssd_corr_f32 (a port
// of scenelib2_tpu/kernels/pallas_score_map.py::nssd_corr_f32,
// improc.cpp:55-134) followed by the low-sigma penalty of the score map
// (pallas_score_map.py:131-135). The same f32 operations in the same order
// (built with -fmad=false). Included by score_map.cu (K9),
// search_bayes.cu (K4, K11) and search.cu (K2, K8: nssd_corr alone); the
// searches' one-word order of (score, cell) is score_key.
#pragma once

#include <math.h>
#include <stdint.h>

// sg0, sg0sq: the patch's sum and sum of squares; sg1, sg1sq, cross: the
// image window's sum, sum of squares and cross sum with the patch; n: the
// number of pixels. Returns the NSSD with its 0 / 1 zero-variance specials
// (search.py::nssd_corr_f32) and the two deviations in *sd0_o, *sd1_o.
__device__ __forceinline__ float nssd_corr(float sg0, float sg0sq, float sg1, float sg1sq, float cross, float n,
                                           float* sd0_o, float* sd1_o) {
  const float g0bar = sg0 / n;
  const float g1bar = sg1 / n;
  const float varg0 = sg0sq / n - g0bar * g0bar;
  const float varg1 = sg1sq / n - g1bar * g1bar;
  const float sd0 = sqrtf(varg0);
  const float sd1 = sqrtf(varg1);
  const float v1s = varg1 == 0.0f ? 1.0f : varg1;
  const float s1 = sqrtf(v1s);
  const float v0s = varg0 == 0.0f ? 1.0f : varg0;
  const float s0 = sqrtf(v0s);
  const float kk = g0bar / s0 - g1bar / s1;
  const float corr = (sg0sq / v0s + sg1sq / v1s + n * (kk * kk) - cross * 2.0f / (s0 * s1)
                      - sg0 * 2.0f * kk / s0 + sg1 * 2.0f * kk / s1) / n;
  const bool both_zero = sd0 == 0.0f && sd1 == 0.0f;
  *sd0_o = sd0;
  *sd1_o = sd1;
  return (sd0 != 0.0f && sd1 != 0.0f) ? corr : (both_zero ? 0.0f : 1.0f);
}

// The score map's form: the NSSD plus low_sigma_penalty where the image
// deviation is below corr_sigma_thresh.
__device__ __forceinline__ float nssd_penalized(float sg0, float sg0sq, float sg1, float sg1sq,
                                                float cross, float n, float corr_sigma_thresh,
                                                float low_sigma_penalty) {
  float sd0, sd1;
  const float corr = nssd_corr(sg0, sg0sq, sg1, sg1sq, cross, n, &sd0, &sd1);
  return sd1 < corr_sigma_thresh ? corr + low_sigma_penalty : corr;
}

// A candidate cell's 64-bit key: the order-preserving bits of its score
// (not NaN) above the complement of uv = u * H + v, so that the unsigned
// minimum is the least score and, among its ties, the largest uv. -0 takes
// +0's bits (the scores of K2, K4, K8, K9 and K11 are never -0: the NSSD's
// numerator starts from terms >= +0 and x - x rounds to +0), so equal
// scores have equal bits and the low word alone breaks ties.
__device__ __forceinline__ unsigned long long score_key(float score, int uv) {
  const uint32_t b = __float_as_uint(score == 0.0f ? 0.0f : score);
  const uint32_t hi = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)hi << 32) | (uint32_t)~(uint32_t)uv;
}

// the score and uv of a key from score_key
__device__ __forceinline__ float key_score(unsigned long long key) {
  const uint32_t hi = (uint32_t)(key >> 32);
  return __uint_as_float((hi & 0x80000000u) ? (hi & 0x7FFFFFFFu) : ~hi);
}
__device__ __forceinline__ int key_uv(unsigned long long key) { return (int)~(uint32_t)key; }
