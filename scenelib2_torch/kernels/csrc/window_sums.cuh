// The three integer sums of the NSSD at a run of adjacent centres, by __dp4a.
//
// A window of u8 pixels is staged as 32-bit words (4 pixels each, little
// end first) in rows of `spw` words; a patch of B x B u8 pixels (B <= 11)
// as WS_NQ zero-padded u8 quads a row. For a run of WS_RUN centres along u
// starting at word i of a staged row, run_sums aligns the 16 bytes of each
// patch row into byte quads once (__byte_perm) and takes the cross sum with
// the patch quads, the sum with ones on the patch's columns and the sum of
// squares of the masked quads, all three with __dp4a. Every sum is an
// integer below 2^24 (at most 121 x 255^2), so its f32 conversion equals the
// twins' f32 sums exactly. Included by search.cu (K2, K8) and
// search_bayes.cu (K4).
#pragma once

#include <stdint.h>

#define WS_RUN 4     // adjacent centres a run
#define WS_NQ 3      // u8 quads a patch row (B <= 12, zero-padded)
#define WS_MAX_B 11  // the patch rows hold B * B + 2 <= 128 floats

// the patch row's f32 pixels (u8 values, truncated) as quads: pq[dy * WS_NQ + t]
// holds columns 4t .. 4t + 3 of row dy; threads tid, tid + nt, ... of the block
__device__ __forceinline__ void patch_quads(const float* row, int B, uint32_t* pq, int tid, int nt) {
  for (int e = tid; e < B * WS_NQ; e += nt) {
    const int dy = e / WS_NQ, t = e - dy * WS_NQ;
    uint32_t w = 0;
    for (int j = 0; j < 4 && 4 * t + j < B; ++j) w |= __float2uint_rz(row[dy * B + 4 * t + j]) << (8 * j);
    pq[e] = w;
  }
}

// the bytes of quad t that hold patch columns (4t + k < B)
__device__ __forceinline__ void quad_masks(int B, uint32_t msk[WS_NQ]) {
#pragma unroll
  for (int t = 0; t < WS_NQ; ++t) {
    const int nk = min(max(B - 4 * t, 0), 4);
    msk[t] = nk == 4 ? 0xFFFFFFFFu : (1u << (8 * nk)) - 1u;
  }
}

// cross, s1, s2 of the WS_RUN centres whose windows start at word i of
// staged row `row` (B rows of spw words from there; 4 words a row are read)
__device__ __forceinline__ void run_sums(const uint32_t* row, int spw, int B, const uint32_t* pq,
                                         const uint32_t msk[WS_NQ], uint32_t cross[WS_RUN], uint32_t s1[WS_RUN],
                                         uint32_t s2[WS_RUN]) {
#pragma unroll
  for (int s = 0; s < WS_RUN; ++s) cross[s] = s1[s] = s2[s] = 0u;
  for (int dy = 0; dy < B; ++dy) {
    const uint32_t* r = row + dy * spw;
    uint32_t w[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) w[t] = r[t];
    uint32_t q[4 * WS_NQ];  // q[o]: the 4 bytes from byte o of the run
#pragma unroll
    for (int o = 0; o < 4 * WS_NQ; ++o)
      q[o] = (o & 3) == 0 ? w[o >> 2] : __byte_perm(w[o >> 2], w[(o >> 2) + 1], 0x3210 + 0x1111 * (o & 3));
#pragma unroll
    for (int t = 0; t < WS_NQ; ++t) {
      const uint32_t pw = pq[dy * WS_NQ + t], ones = msk[t] & 0x01010101u;
#pragma unroll
      for (int s = 0; s < WS_RUN; ++s) {
        const uint32_t x = q[s + 4 * t], xm = x & msk[t];
        cross[s] = __dp4a(x, pw, cross[s]);
        s1[s] = __dp4a(x, ones, s1[s]);
        s2[s] = __dp4a(xm, xm, s2[s]);
      }
    }
  }
}
