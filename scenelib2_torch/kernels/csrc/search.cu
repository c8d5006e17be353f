// K2: NSSD elliptical search of the selected features.
//
// Replaces scenelib2_tpu/kernels/pallas_search.py
// (pallas_elliptical_search_fused / _search_kernel_fused -> _search_body ->
// _score_and_select, with pallas_score_map.py::nssd_corr_f32). The plain
// PyTorch twin is scenelib2_torch/kernels/search.py::search_plain; the NSSD
// formula runs the same f32 operations in the same order (built with
// -fmad=false), and the integer sums are exact in any order.
//
// Bound on an H100: ~60 KB of windows and ~10 MFLOP for 10 features, far
// below a microsecond; the launch dominates. Design: one block per selected
// feature; in the batch step the features of all lanes are one grid
// (feature k searches frame k / per_lane), so one launch serves every lane.
// The block stages its (side + B - 1)^2 window of the u8 frame (as dynamic
// shared memory: 75^2 floats at 320x240, 107^2 at the 640x480 radius 48)
// and its patch in shared memory; threads stride over the candidate centres,
// score only those inside the ellipse's 3-sigma box (every other candidate
// is masked out anyway), then reduce the minimum and, among the cells at the
// minimum, the largest u*H + v key (the reference keeps the LAST tie in
// u-outer / v-inner scan order).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K2_THREADS 256
// the (side + B - 1)^2 window is dynamic shared memory: 107^2 floats
// (45.8 KB) at the hires radius 48, up to 200 KB on request
#define K2_MAX_WIN_BYTES (200 * 1024)

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

__global__ void __launch_bounds__(K2_THREADS)
k2_kernel(const uint8_t* __restrict__ frame, const float* __restrict__ patch_rows,
          const int* __restrict__ u0s, const int* __restrict__ v0s, const int* __restrict__ ucs,
          const int* __restrict__ vcs, const float* __restrict__ sinv_abc,
          const uint8_t* __restrict__ active, uint8_t* __restrict__ found, int* __restrict__ uo,
          int* __restrict__ vo, float* __restrict__ best_o, uint8_t* __restrict__ over_o,
          K2Params p) {
  extern __shared__ float win[];  // [wv][wu]
  __shared__ float patch[128];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int k = blockIdx.x;
  const int B = p.B, half = (B - 1) / 2;
  const int sv = p.side_v, su = p.side_u;
  const int wv = sv + B - 1, wu = su + B - 1;
  const int u0 = u0s[k], v0 = v0s[k], uc = ucs[k], vc = vcs[k];
  const float a = sinv_abc[3 * k], b = sinv_abc[3 * k + 1], c = sinv_abc[3 * k + 2];

  const uint8_t* __restrict__ fr = frame + (size_t)(k / p.per_lane) * p.H * p.W;
  for (int e = threadIdx.x; e < wv * wu; e += blockDim.x) {
    const int r = e / wu, cc = e - r * wu;
    win[e] = (float)fr[(v0 - half + r) * p.W + (u0 - half + cc)];
  }
  for (int e = threadIdx.x; e < 128; e += blockDim.x) patch[e] = patch_rows[128 * k + e];
  __syncthreads();

  const float halfwidth = floorf(p.no_sigma / sqrtf(a - b * b / c));
  const float halfheight = floorf(p.no_sigma / sqrtf(c - b * b / a));
  const float sg0 = patch[B * B], sg0sq = patch[B * B + 1];

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
    const bool act = active[k] != 0;
    best_o[k] = best;
    uo[k] = kbest >= 0 ? kbest / p.H : -1;
    vo[k] = kbest >= 0 ? kbest % p.H : -1;
    found[k] = act && best <= p.corr_thresh2;
    over_o[k] = act && (halfwidth > (float)(su / 2) || halfheight > (float)(sv / 2));
  }
}

extern "C" int k2_search(const uint8_t* frame, const float* patch_rows, const int* u0,
                         const int* v0, const int* uc, const int* vc, const float* sinv_abc,
                         const uint8_t* active, uint8_t* found, int* u, int* v, float* best,
                         uint8_t* over, int K, const K2Params* p, void* stream) {
  const size_t smem = sizeof(float) * (size_t)(p->side_v + p->B - 1) * (p->side_u + p->B - 1);
  if (smem > K2_MAX_WIN_BYTES || p->per_lane < 1) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  // above 48 KB of static + dynamic shared memory the kernel must opt in;
  // the attribute belongs to the current device, so it is set on every launch
  cudaError_t e = cudaFuncSetAttribute(k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k2_kernel<<<K, K2_THREADS, smem, (cudaStream_t)stream>>>(frame, patch_rows, u0, v0, uc, vc, sinv_abc,
                                                           active, found, u, v, best, over, *p);
  return (int)cudaGetLastError();
}
