// K2 and K8: NSSD elliptical search of the selected features.
//
// K2 replaces scenelib2_tpu/kernels/pallas_search.py
// (pallas_elliptical_search_fused / _search_kernel_fused -> _search_body ->
// _score_and_select, with pallas_score_map.py::nssd_corr_f32); K8 replaces
// the same file's pallas_elliptical_search (_search_kernel, pallas_call at
// pallas_search.py:312), the batch route with batch_pallas=False, whose
// caller gathers each feature's u8 window from its frame first. Both score
// and select in search_cell.cuh. The plain PyTorch twins are
// scenelib2_torch/kernels/search.py::search_plain and search_windows_plain;
// the NSSD formula runs the same f32 operations in the same order (built
// with -fmad=false), and the integer sums are exact in any order.
//
// Bound on an H100: ~60 KB of windows and ~10 MFLOP for 10 features, far
// below a microsecond; the launch dominates (at 64 lanes x 10 features,
// 3.6 MB of u8 windows: ~1 us at the memory rate). Design: one block per
// selected feature; in the batch step the features of all lanes are one
// grid (K2: feature k searches frame k / per_lane), so one launch serves
// every lane. The block stages its (side + B - 1)^2 window (K2: from the u8
// frame; K8: from the gathered u8 window) as floats in dynamic shared
// memory (75^2 floats at 320x240, 107^2 at the 640x480 radius 48) and its
// patch in shared memory; threads stride over the candidate centres, score
// only those inside the ellipse's 3-sigma box (every other candidate is
// masked out anyway), then reduce the minimum and, among the cells at the
// minimum, the largest u*H + v key.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "search_cell.cuh"

#define K2_THREADS 256
// the (side + B - 1)^2 window is dynamic shared memory: 107^2 floats
// (45.8 KB) at the hires radius 48, up to 200 KB on request
#define K2_MAX_WIN_BYTES (200 * 1024)

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
  const int wv = p.side_v + B - 1, wu = p.side_u + B - 1;
  const int u0 = u0s[k], v0 = v0s[k];

  const uint8_t* __restrict__ fr = frame + (size_t)(k / p.per_lane) * p.H * p.W;
  for (int e = threadIdx.x; e < wv * wu; e += blockDim.x) {
    const int r = e / wu, cc = e - r * wu;
    win[e] = (float)fr[(v0 - half + r) * p.W + (u0 - half + cc)];
  }
  for (int e = threadIdx.x; e < 128; e += blockDim.x) patch[e] = patch_rows[128 * k + e];
  __syncthreads();
  search_select(win, patch, patch[B * B], patch[B * B + 1], k, u0, v0, ucs[k], vcs[k],
                sinv_abc[3 * k], sinv_abc[3 * k + 1], sinv_abc[3 * k + 2], active[k] != 0, p, redf,
                redi, found, uo, vo, best_o, over_o);
}

// K8: windows [K][wv][wu] u8 (gathered at (u0 - half, v0 - half)), patches
// [K][B][B] u8, sg0 / sg0sq [K] (the patch's integer sums, from the wrapper)
__global__ void __launch_bounds__(K2_THREADS)
k8_kernel(const uint8_t* __restrict__ windows, const uint8_t* __restrict__ patches,
          const float* __restrict__ sg0s, const float* __restrict__ sg0sqs,
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
  const int B = p.B;
  const int n_win = (p.side_v + B - 1) * (p.side_u + B - 1);
  const uint8_t* __restrict__ w = windows + (size_t)k * n_win;
  for (int e = threadIdx.x; e < n_win; e += blockDim.x) win[e] = (float)w[e];
  for (int e = threadIdx.x; e < B * B; e += blockDim.x) patch[e] = (float)patches[(size_t)k * B * B + e];
  __syncthreads();
  search_select(win, patch, sg0s[k], sg0sqs[k], k, u0s[k], v0s[k], ucs[k], vcs[k], sinv_abc[3 * k],
                sinv_abc[3 * k + 1], sinv_abc[3 * k + 2], active[k] != 0, p, redf, redi, found, uo,
                vo, best_o, over_o);
}

static size_t window_bytes(const K2Params* p) {
  return sizeof(float) * (size_t)(p->side_v + p->B - 1) * (p->side_u + p->B - 1);
}

extern "C" int k2_search(const uint8_t* frame, const float* patch_rows, const int* u0,
                         const int* v0, const int* uc, const int* vc, const float* sinv_abc,
                         const uint8_t* active, uint8_t* found, int* u, int* v, float* best,
                         uint8_t* over, int K, const K2Params* p, void* stream) {
  const size_t smem = window_bytes(p);
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

extern "C" int k8_search_windows(const uint8_t* windows, const uint8_t* patches, const float* sg0,
                                 const float* sg0sq, const int* u0, const int* v0, const int* uc,
                                 const int* vc, const float* sinv_abc, const uint8_t* active,
                                 uint8_t* found, int* u, int* v, float* best, uint8_t* over, int K,
                                 const K2Params* p, void* stream) {
  const size_t smem = window_bytes(p);
  if (smem > K2_MAX_WIN_BYTES || p->B * p->B > 128) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  cudaError_t e = cudaFuncSetAttribute(k8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k8_kernel<<<K, K2_THREADS, smem, (cudaStream_t)stream>>>(windows, patches, sg0, sg0sq, u0, v0, uc, vc,
                                                           sinv_abc, active, found, u, v, best, over, *p);
  return (int)cudaGetLastError();
}
