// Penalized NSSD score from exact integer sums.
//
// The CUDA form of scenelib2_torch/kernels/search.py::nssd_corr_f32 (a port
// of scenelib2_tpu/kernels/pallas_score_map.py::nssd_corr_f32,
// improc.cpp:55-134) followed by the low-sigma penalty of the score map
// (pallas_score_map.py:131-135). The same f32 operations in the same order
// (built with -fmad=false). Included by score_map.cu (K9) and
// search_bayes.cu (K4).
#pragma once

#include <math.h>

// sg0, sg0sq: the patch's sum and sum of squares; sg1, sg1sq, cross: the
// image window's sum, sum of squares and cross sum with the patch; n: the
// number of pixels.
__device__ __forceinline__ float nssd_penalized(float sg0, float sg0sq, float sg1, float sg1sq,
                                                float cross, float n, float corr_sigma_thresh,
                                                float low_sigma_penalty) {
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
  float corr = (sg0sq / v0s + sg1sq / v1s + n * (kk * kk) - cross * 2.0f / (s0 * s1)
                - sg0 * 2.0f * kk / s0 + sg1 * 2.0f * kk / s1) / n;
  const bool both_zero = sd0 == 0.0f && sd1 == 0.0f;
  corr = (sd0 != 0.0f && sd1 != 0.0f) ? corr : (both_zero ? 0.0f : 1.0f);
  return sd1 < corr_sigma_thresh ? corr + low_sigma_penalty : corr;
}
