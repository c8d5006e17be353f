// K9: whole-frame penalized NSSD score map of one patch per partial slot,
// for every lane of the batch step.
//
// Replaces scenelib2_tpu/kernels/pallas_score_map.py (pallas_score_maps:
// _score_map_kernel_whole and the banded _score_map_kernel; one function).
// The plain PyTorch twin is scenelib2_torch/kernels/score_map.py::
// score_map_plain. The three sums are integers below 2^24 (at most
// 121 x 255^2 = 7,868,025 for an 11 x 11 patch of u8 pixels: the patch rows
// hold u8 pixels, runtime/state.py::patch_row), so integer arithmetic in any
// order gives the twin's f32 sums exactly after one exact conversion; only
// the score formula rounds, nssd.cuh, in the twin's order (built with
// -fmad=false). The two agree bit for bit.
//
// Bound on an H100 at 64 lanes of 320x240: 4.9 MB in and 19.7 MB out (~7 us
// at the memory rate) against ~1.4 GOP (~21 us at the f32 rate): bound by
// operations, most of them the score formula's. Design: one block of 8 x 16
// threads per (lane, 16 x 64 tile of centres); each thread takes a run of 8
// adjacent centres along u:
//   - the frame tile (16 + B - 1 rows, 80 columns from 8 left of the tile)
//     is staged as u8 words (4-byte loads where W is a multiple of 4), at a
//     row pitch of 48 words so that each half-warp's 8-byte loads meet 32
//     distinct banks;
//   - box sums, separably, in int32: the block's column sums over B rows
//     (sum and sum of squares, one thread a column sliding down), then each
//     thread's sliding sum along u over its 8 windows (pitch 81: 2-way at most);
//   - the cross sum on the integer units: per patch row, the thread's 6 frame
//     words are aligned into byte quads (__byte_perm) once for all 8
//     centres, and each centre takes ceil(B / 4) __dp4a with the patch row's
//     zero-padded u8 quads: 4 exact multiply-adds an instruction. Tensor
//     cores would not pay: with one patch a (lane, slot) the product's N
//     dimension is 1, so mma / wgmma on u8 would run at 1/8 of their width
//     or less;
//   - 8 contiguous scores a thread, written as two 16-byte stores.
// A centre whose patch leaves the frame gets exactly 1e6. Slots of a lane
// (F > 1) reuse the staged frame and the box sums. B is odd (the window is
// centred: the twin pads (B - 1) / 2 on each side) and at most 11.
#include <cuda_runtime.h>
#include <stdint.h>

#include "nssd.cuh"

#define K9_TX 8        // threads along u, 8 centres each
#define K9_TV 16       // rows of centres (threads along v)
#define K9_TU (8 * K9_TX)
#define K9_THREADS (K9_TX * K9_TV)
#define K9_PAD 8       // staged columns left of the tile (>= (B - 1) / 2, keeps words aligned)
#define K9_COLS 80     // staged columns: K9_PAD + K9_TU + 8
#define K9_PITCH 48    // words a staged row (>= K9_COLS / 4, = 16 mod 32)
#define K9_CPITCH 81   // ints a row of column sums (odd)
#define K9_MAXB 11
#define K9_MISS 1e6f

struct K9Params {
  int H, W, B, n_lanes, F;
  float corr_sigma_thresh, low_sigma_penalty;
};

template <int B>
__global__ void __launch_bounds__(K9_THREADS)
k9_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ patch_rows,
          float* __restrict__ out, K9Params p, bool words, bool vec_out) {
  constexpr int HALF = (B - 1) / 2;
  constexpr int NQ = (B + 3) / 4;          // byte quads a patch row
  constexpr int O0 = K9_PAD - HALF;        // first window byte of a thread's first centre, from its span
  constexpr int NQO = 8 + 4 * (NQ - 1);    // quad start offsets a row needs: O0 .. O0 + NQO - 1
  constexpr int NW = ((((O0 + NQO - 1) >> 2) + 2) + 1) & ~1;  // words a row, read as pairs
  constexpr int TH = K9_TV + B - 1;        // staged rows
  static_assert(8 * (K9_TX - 1) + 4 * NW <= K9_COLS, "a thread's span lies in the staged columns");
  __shared__ __align__(16) uint32_t tile[TH * K9_PITCH];
  __shared__ int cs[K9_TV * K9_CPITCH], cq[K9_TV * K9_CPITCH];
  __shared__ uint32_t pq[B * NQ];
  __shared__ float pstat[2];
  const int lane = blockIdx.z;
  const int u_al = blockIdx.x * K9_TU, v_al = blockIdx.y * K9_TV;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * K9_TX + tx;
  const uint8_t* frame = frames + (size_t)lane * p.H * p.W;
  uint8_t* tb = reinterpret_cast<uint8_t*>(tile);

  // ---- stage rows v_al - HALF + r, columns u_al - K9_PAD + c (0 outside the
  // frame): as 4-byte words where `words` (W a multiple of 4 and the frames
  // 4-byte aligned: a staged word then lies wholly inside or wholly outside
  // the frame), all loads in flight
  if (words) {
    constexpr int NWR = K9_COLS / 4;  // words a staged row
#pragma unroll
    for (int e = tid; e < TH * NWR; e += K9_THREADS) {
      const int r = e / NWR, c = e - r * NWR;
      const int v = v_al - HALF + r, u = u_al - K9_PAD + 4 * c;
      tile[r * K9_PITCH + c] = (v >= 0 && v < p.H && u >= 0 && u < p.W)
                                   ? *reinterpret_cast<const uint32_t*>(frame + (size_t)v * p.W + u)
                                   : 0u;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < TH * K9_COLS; e += K9_THREADS) {
      const int r = e / K9_COLS, c = e - r * K9_COLS;
      const int v = v_al - HALF + r, u = u_al - K9_PAD + c;
      tb[r * K9_PITCH * 4 + c] = (v >= 0 && v < p.H && u >= 0 && u < p.W) ? frame[(size_t)v * p.W + u] : 0;
    }
  }
  __syncthreads();
  // ---- column sums over B rows: a thread a (column, sum or squares), sliding down
  for (int e = tid; e < 2 * K9_COLS; e += K9_THREADS) {
    const bool sq = e >= K9_COLS;
    const int c = sq ? e - K9_COLS : e;
    int* col = sq ? cq : cs;
    int acc = 0;
    for (int dy = 0; dy < B; ++dy) {
      const int w = tb[dy * K9_PITCH * 4 + c];
      acc += sq ? w * w : w;
    }
    col[c] = acc;
    for (int r = 1; r < K9_TV; ++r) {
      const int wa = tb[(r + B - 1) * K9_PITCH * 4 + c], wb = tb[(r - 1) * K9_PITCH * 4 + c];
      acc += sq ? wa * wa - wb * wb : wa - wb;
      col[r * K9_CPITCH + c] = acc;
    }
  }
  __syncthreads();
  // ---- this thread's 8 window sums, sliding along u
  const int base = 8 * tx + O0;
  int sg1[8], sg1sq[8];
  {
    const int* crow = cs + ty * K9_CPITCH + base;
    const int* qrow = cq + ty * K9_CPITCH + base;
    int a = 0, b = 0;
#pragma unroll
    for (int k = 0; k < B; ++k) {
      a += crow[k];
      b += qrow[k];
    }
    sg1[0] = a;
    sg1sq[0] = b;
#pragma unroll
    for (int s = 1; s < 8; ++s) {
      a += crow[s + B - 1] - crow[s - 1];
      b += qrow[s + B - 1] - qrow[s - 1];
      sg1[s] = a;
      sg1sq[s] = b;
    }
  }

  const int v = v_al + ty;
  const int u0 = u_al + 8 * tx;
  const bool vrow = v >= HALF && v <= p.H - 1 - HALF;
  for (int f = 0; f < p.F; ++f) {
    const size_t lf = (size_t)lane * p.F + f;
    // ---- the slot's patch as zero-padded u8 quads
    __syncthreads();
    if (tid < B * NQ) {
      const int dy = tid / NQ, t = tid - dy * NQ;
      uint32_t w = 0;
      for (int k = 0; k < 4; ++k) {
        const int dx = 4 * t + k;
        if (dx < B) w |= (uint32_t)patch_rows[lf * 128 + dy * B + dx] << (8 * k);
      }
      pq[tid] = w;
    }
    if (tid == 0) {
      pstat[0] = patch_rows[lf * 128 + B * B];
      pstat[1] = patch_rows[lf * 128 + B * B + 1];
    }
    __syncthreads();
    // ---- cross sums: 8 centres x NQ dp4a a patch row
    uint32_t cross[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) cross[s] = 0u;
#pragma unroll
    for (int dy = 0; dy < B; ++dy) {
      uint32_t wv[NW];
      const uint2* row = reinterpret_cast<const uint2*>(tile + (ty + dy) * K9_PITCH + 2 * tx);
#pragma unroll
      for (int k = 0; k < NW / 2; ++k) {
        const uint2 w2 = row[k];
        wv[2 * k] = w2.x;
        wv[2 * k + 1] = w2.y;
      }
      uint32_t q[NQO];  // q[o]: the 4 bytes from byte O0 + o of the span
#pragma unroll
      for (int o = 0; o < NQO; ++o) {
        const int b0 = O0 + o, sh = b0 & 3;
        q[o] = sh == 0 ? wv[b0 >> 2] : __byte_perm(wv[b0 >> 2], wv[(b0 >> 2) + 1], 0x3210 + 0x1111 * sh);
      }
#pragma unroll
      for (int t = 0; t < NQ; ++t) {
        const uint32_t pw = pq[dy * NQ + t];
#pragma unroll
        for (int s = 0; s < 8; ++s) cross[s] = __dp4a(q[s + 4 * t], pw, cross[s]);
      }
    }
    // ---- scores: straight-line over the 8 centres (the validity is a select
    // afterwards), so that the compiler computes the patch's terms of the
    // formula (its mean, variance, deviation) once for all 8
    const float sg0 = pstat[0], sg0sq = pstat[1];
    float sc[8];
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int u = u0 + s;
      const float score = nssd_penalized(sg0, sg0sq, (float)sg1[s], (float)sg1sq[s], (float)cross[s],
                                         (float)(B * B), p.corr_sigma_thresh, p.low_sigma_penalty);
      sc[s] = (vrow && u >= HALF && u <= p.W - 1 - HALF) ? score : K9_MISS;
    }
    if (v < p.H) {
      float* o = out + (lf * p.H + v) * p.W + u0;
      if (vec_out && u0 + 8 <= p.W) {
        reinterpret_cast<float4*>(o)[0] = make_float4(sc[0], sc[1], sc[2], sc[3]);
        reinterpret_cast<float4*>(o)[1] = make_float4(sc[4], sc[5], sc[6], sc[7]);
      } else {
        for (int s = 0; s < 8 && u0 + s < p.W; ++s) o[s] = sc[s];
      }
    }
  }
}

template <int B>
static cudaError_t k9_launch(const uint8_t* frames, const float* patch_rows, float* out, const K9Params& p,
                             cudaStream_t stream) {
  const dim3 grid((p.W + K9_TU - 1) / K9_TU, (p.H + K9_TV - 1) / K9_TV, p.n_lanes);
  // 4-byte loads of the frames and 16-byte stores of the maps where W and the
  // pointers allow them
  const bool words = p.W % 4 == 0 && reinterpret_cast<uintptr_t>(frames) % 4 == 0;
  const bool vec_out = p.W % 4 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  k9_kernel<B><<<grid, dim3(K9_TX, K9_TV), 0, stream>>>(frames, patch_rows, out, p, words, vec_out);
  return cudaGetLastError();
}

extern "C" int k9_score_map(const uint8_t* frames, const float* patch_rows, float* out,
                            const K9Params* p, void* stream) {
  if (p->B < 1 || p->B > K9_MAXB || p->B % 2 == 0) return (int)cudaErrorInvalidValue;
  if (p->n_lanes == 0 || p->F == 0) return 0;
  if (p->n_lanes > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (p->B) {
    case 1: return (int)k9_launch<1>(frames, patch_rows, out, *p, s);
    case 3: return (int)k9_launch<3>(frames, patch_rows, out, *p, s);
    case 5: return (int)k9_launch<5>(frames, patch_rows, out, *p, s);
    case 7: return (int)k9_launch<7>(frames, patch_rows, out, *p, s);
    case 9: return (int)k9_launch<9>(frames, patch_rows, out, *p, s);
    default: return (int)k9_launch<11>(frames, patch_rows, out, *p, s);
  }
}
