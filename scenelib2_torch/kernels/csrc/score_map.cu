// K9: whole-frame penalized NSSD score map of one patch per partial slot,
// for every lane of the batch step.
//
// Replaces scenelib2_tpu/kernels/pallas_score_map.py (pallas_score_maps:
// _score_map_kernel_whole and the banded _score_map_kernel; one function).
// The plain PyTorch twin is scenelib2_torch/kernels/score_map.py::
// score_map_plain. The three sums are integers below 2^24, exact in f32 in
// any order; the score formula is nssd.cuh (built with -fmad=false).
//
// Bound on an H100 at 64 lanes of 320x240: 4.9 MB in and 19.7 MB out (~7 us
// at the memory rate) against ~1.4 GOP (~21 us at the f32 rate): bound by
// operations. Design: one block per (lane x slot, 16 x 32 tile of centres).
// The block stages its tile of the u8 frame with the (B-1)/2-pixel halo as
// floats in shared memory, and the patch row; one thread per centre sums
// its B*B taps. A centre whose patch leaves the frame gets exactly 1e6.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nssd.cuh"

#define K9_TV 16
#define K9_TU 32
#define K9_MAXB 11
#define K9_MISS 1e6f

struct K9Params {
  int H, W, B, n_lanes, F;
  float corr_sigma_thresh, low_sigma_penalty;
};

__global__ void __launch_bounds__(K9_TV * K9_TU)
k9_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ patch_rows,
          float* __restrict__ out, K9Params p) {
  __shared__ float tile[(K9_TV + K9_MAXB - 1) * (K9_TU + K9_MAXB - 1)];
  __shared__ float patch[128];
  const int B = p.B, half = (B - 1) / 2;
  const int lf = blockIdx.z;            // lane * F + slot
  const int lane = lf / p.F;
  const int v_al = blockIdx.y * K9_TV, u_al = blockIdx.x * K9_TU;
  const int tw = K9_TU + B - 1, th = K9_TV + B - 1;
  const int tid = threadIdx.y * K9_TU + threadIdx.x;
  const uint8_t* frame = frames + (size_t)lane * p.H * p.W;

  for (int e = tid; e < th * tw; e += K9_TV * K9_TU) {
    const int r = e / tw, cc = e - r * tw;
    const int v = v_al - half + r, u = u_al - half + cc;
    tile[e] = (v >= 0 && v < p.H && u >= 0 && u < p.W) ? (float)frame[v * p.W + u] : 0.0f;
  }
  if (tid < 128) patch[tid] = patch_rows[(size_t)lf * 128 + tid];
  __syncthreads();

  const int v = v_al + threadIdx.y, u = u_al + threadIdx.x;
  if (v >= p.H || u >= p.W) return;
  float score = K9_MISS;
  if (u >= half && u <= p.W - 1 - half && v >= half && v <= p.H - 1 - half) {
    float sg1 = 0.0f, sg1sq = 0.0f, cross = 0.0f;  // integer-valued: exact in any order
    for (int dy = 0; dy < B; ++dy) {
      const float* row = tile + (threadIdx.y + dy) * tw + threadIdx.x;
      const float* prow = patch + dy * B;
      for (int dx = 0; dx < B; ++dx) {
        const float w = row[dx];
        sg1 = sg1 + w;
        sg1sq = sg1sq + w * w;
        cross = cross + prow[dx] * w;
      }
    }
    score = nssd_penalized(patch[B * B], patch[B * B + 1], sg1, sg1sq, cross, (float)(B * B),
                           p.corr_sigma_thresh, p.low_sigma_penalty);
  }
  out[((size_t)lf * p.H + v) * p.W + u] = score;
}

extern "C" int k9_score_map(const uint8_t* frames, const float* patch_rows, float* out,
                            const K9Params* p, void* stream) {
  if (p->B > K9_MAXB || p->B * p->B + 2 > 128) return (int)cudaErrorInvalidValue;
  const int nz = p->n_lanes * p->F;
  if (nz == 0) return 0;
  if (nz > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((p->W + K9_TU - 1) / K9_TU, (p->H + K9_TV - 1) / K9_TV, nz);
  const dim3 block(K9_TU, K9_TV);
  k9_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(frames, patch_rows, out, *p);
  return (int)cudaGetLastError();
}
