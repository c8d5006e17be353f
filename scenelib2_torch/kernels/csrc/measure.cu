// K7: per-slot measurement prediction and the top-NSEL selection for every
// lane of the batch step (and of the single stream's split route, as one
// lane).
//
// Replaces scenelib2_tpu/kernels/pallas_measure.py (pallas_measure_predict /
// _measure_kernel -> _measure_math) together with what the JAX batch step
// does with its rows: lax.top_k of the score row, the visible count and the
// gather of the selected rows. The plain PyTorch twin is scenelib2_torch/
// kernels/measure.py::measure_select_plain (the slot gathers, the chain of
// measure_predict_plain, the count, stable_top_k and the gather); the chain
// is measure_chain.cuh, shared with K1 (built with -fmad=false, the same
// operations in the same order), so the two agree bit for bit.
//
// Bound on an H100 (measure.py::bytes_and_flops): ~40 floats in a slot, the
// selected rows out; 0.26 MB and ~0.6 MFLOP at 64 lanes x 16 slots, well
// under a microsecond: the launch and one slot's dependent chain set the
// time. Design: one CTA a lane, of 4 warps for every 32 slots (MF <= 128).
//   - staging: x, P and xp_org are read in place (D from the caller) by
//     four warp groups at once, a thread a slot issuing all its loads
//     before it stores any: pxy (P's rows 0..6 at the slot's columns,
//     neighbouring threads on neighbouring slots), pyy and the point, the
//     capture pose; the last group the masks, the lane's 7 x 7 Pxx and
//     pose, and its two rotations, formed once (meas_cam).
//   - phase 1: warp group A (a thread a slot) the projection, Jacobians and
//     noise; warp group B (a thread a slot) the visibility chain on the
//     capture pose, which needs neither.
//   - phase 2: the three entries of S of every slot, one thread each.
//   - phase 3: a thread a slot adds R, inverts S, forms the visibility row
//     and the score; n_visible by __syncthreads_count.
//   - the rank by pairwise comparison of one 64-bit key a slot (rank_key:
//     stable_top_k's order, descending, ties to the lowest slot, a NaN
//     ahead of every number), split in four interleaved parts a slot and
//     summed by shared atomics (integers, so in any order); a slot ranked
//     below NSEL writes its selected row.
// Five block barriers, none of them inside a loop.
#include <cuda_runtime.h>
#include <stdint.h>

#include "measure_chain.cuh"

#define K7_MAX_MF 128
#define K7_PARTS 4  // warps a 32-slot group, and parts of each slot's rank
#define N_SEL_F 31  // floats of a selected row: score, h 2, hx 14, hy 6, Rd, S 4, sinv 3

// where each selected quantity starts in the float output, in units of
// B * NSEL (measure.py::SEL_LAYOUT)
#define SEL_SCORE 0
#define SEL_H 1
#define SEL_HX 3
#define SEL_HY 17
#define SEL_RD 23
#define SEL_S 24
#define SEL_SINV 28

// A slot's rank key: the score's order-preserving bits (any NaN above every
// number, -0 equal to +0), then the complement of the slot, so that one
// unsigned comparison gives stable_top_k's order (ties to the lowest slot).
__device__ __forceinline__ unsigned long long rank_key(float v, int slot) {
  unsigned int b = 0xFFFFFFFFu;
  if (v == v) {
    const unsigned int u = __float_as_uint(v == 0.0f ? 0.0f : v);
    b = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  }
  return ((unsigned long long)b << 32) | (0xFFFFFFFFu - (unsigned int)slot);
}

__global__ void __launch_bounds__(K7_PARTS * K7_MAX_MF)
k7_kernel(const float* __restrict__ x, const float* __restrict__ P, const float* __restrict__ xp_org,
          const uint8_t* __restrict__ active, const uint8_t* __restrict__ full, int D, int MF, int NSEL,
          float* __restrict__ fout, int* __restrict__ iout, float* __restrict__ rows, MeasConsts c) {
  __shared__ float s_r[3], s_pxx[7][7];
  __shared__ MeasCam s_cam;
  __shared__ float s_y[K7_MAX_MF][3], s_xpo[K7_MAX_MF][7];
  __shared__ float s_pxy[K7_MAX_MF][7][3], s_pyy[K7_MAX_MF][3][3];
  __shared__ float s_m[NOUT][K7_MAX_MF];  // each slot's row (O_*)
  __shared__ float s_S[3][K7_MAX_MF];     // S00, S10, S11 before R
  __shared__ int s_flags[K7_MAX_MF], s_rank[K7_MAX_MF];
  __shared__ unsigned long long s_key[K7_MAX_MF];
  __shared__ uint8_t s_act[K7_MAX_MF];

  const int lane = blockIdx.x, t = threadIdx.x, nt = blockDim.x;
  const int G = nt / K7_PARTS;  // threads a warp group: 32 for every 32 slots
  const float* xl = x + (size_t)lane * D;
  const float* Pl = P + (size_t)lane * D * D;
  const int off0 = 13;          // CAM_DIM: slot s's block starts at 13 + 6 s

  // ---- staging: four warp groups, each thread issuing its slot's loads at
  // once (unrolled), so each group waits for one round trip
  const int g = t / G, s0 = t - g * G;
  if (s0 < MF) {
    const int o = off0 + 6 * s0;
    if (g == 0) {         // pxy: P's rows 0..6 at the slot's first three columns
      float v[21];
#pragma unroll
      for (int a = 0; a < 7; ++a)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[3 * a + j] = Pl[(size_t)a * D + o + j];
#pragma unroll
      for (int a = 0; a < 7; ++a)
#pragma unroll
        for (int j = 0; j < 3; ++j) s_pxy[s0][a][j] = v[3 * a + j];
    } else if (g == 1) {  // pyy and the point
      float v[12];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) v[3 * i + j] = Pl[(size_t)(o + i) * D + o + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) v[9 + j] = xl[o + j];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) s_pyy[s0][i][j] = v[3 * i + j];
#pragma unroll
      for (int j = 0; j < 3; ++j) s_y[s0][j] = v[9 + j];
    } else if (g == 2) {  // the capture pose
      float v[7];
#pragma unroll
      for (int j = 0; j < 7; ++j) v[j] = xp_org[((size_t)lane * MF + s0) * 7 + j];
#pragma unroll
      for (int j = 0; j < 7; ++j) s_xpo[s0][j] = v[j];
    }
  }
  if (g == 3) {           // the masks, and the lane's Pxx, r and both rotations (G >= 32)
    const int e1 = s0 + G;
    float p0 = 0.0f, p1 = 0.0f, r0 = 0.0f;
    bool act = false;
    if (s0 < 49) p0 = Pl[(s0 / 7) * D + s0 % 7];
    if (e1 < 49) p1 = Pl[(e1 / 7) * D + e1 % 7];
    if (s0 < 3) r0 = xl[s0];
    if (s0 < MF) act = active[lane * MF + s0] != 0 && full[lane * MF + s0] != 0;
    if (s0 < 49) s_pxx[s0 / 7][s0 % 7] = p0;
    if (e1 < 49) s_pxx[e1 / 7][e1 % 7] = p1;
    if (s0 < 3) s_r[s0] = r0;
    if (s0 < MF) {
      s_act[s0] = act;
      s_rank[s0] = 0;
    }
    if (s0 == G - 1) {
      const float q[4] = {xl[3], xl[4], xl[5], xl[6]};
      meas_cam(q, s_cam);
    }
  }
  __syncthreads();

  // ---- phase 1: A the geometry, B the capture-pose visibility chain
  if (t < G) {
    const int s = t;
    if (s < MF) {
      float zed[3], hu, hv, hx[2][7], hy[2][3], Rd;
      meas_geom(s_r, s_cam, s_y[s], c, zed, &hu, &hv, hx, hy, &Rd);
      s_m[O_H][s] = hu;
      s_m[O_H + 1][s] = hv;
      for (int i = 0; i < 2; ++i)
        for (int a = 0; a < 7; ++a) s_m[O_HX + 7 * i + a][s] = hx[i][a];
      for (int i = 0; i < 2; ++i)
        for (int j = 0; j < 3; ++j) s_m[O_HY + 3 * i + j][s] = hy[i][j];
      s_m[O_RD][s] = Rd;
      s_m[O_ZZ][s] = zed[2];
    }
  } else if (t < 2 * G) {
    const int s = t - G;
    if (s < MF) {
      float ymr[3], zed[3];
      meas_zed(s_r, s_cam, s_y[s], ymr, zed);
      s_flags[s] = meas_vis_flags(s_cam, zed, s_y[s], s_xpo[s], c);
    }
  }
  __syncthreads();

  // ---- phase 2: S[a][b] of every slot, (a, b) = (0, 0), (1, 0), (1, 1)
  for (int e = t; e < 3 * MF; e += nt) {
    const int entry = e / MF, s = e - entry * MF;
    const int a = entry > 0, b = entry > 1;
    float hxa[7], hya[3], hxb[7], hyb[3];
    for (int i = 0; i < 7; ++i) {
      hxa[i] = s_m[O_HX + 7 * a + i][s];
      hxb[i] = s_m[O_HX + 7 * b + i][s];
    }
    for (int j = 0; j < 3; ++j) {
      hya[j] = s_m[O_HY + 3 * a + j][s];
      hyb[j] = s_m[O_HY + 3 * b + j][s];
    }
    s_S[entry][s] = meas_S(s_pxx, s_pxy[s], s_pyy[s], hxa, hya, hxb, hyb);
  }
  __syncthreads();

  // ---- phase 3: R, S^-1, the visibility row and the score
  bool vis_here = false;
  if (t < MF) {
    const int s = t;
    const float Rd = s_m[O_RD][s];
    const float S00 = s_S[0][s] + Rd;
    const float S01 = s_S[1][s];
    const float S11 = s_S[2][s] + Rd;
    float sinv[3];
    meas_sinv(S00, S01, S11, sinv);
    const float vis = meas_vis(s_m[O_H][s], s_m[O_H + 1][s], s_flags[s], c);
    vis_here = s_act[s] && (vis == 0.0f);
    s_m[O_S][s] = S00;
    s_m[O_S + 1][s] = S01;
    s_m[O_S + 2][s] = S11;
    s_m[O_SINV][s] = sinv[0];
    s_m[O_SINV + 1][s] = sinv[1];
    s_m[O_SINV + 2][s] = sinv[2];
    s_m[O_VIS][s] = vis;
    const float score = vis_here ? S00 + S11 : -INFINITY;
    s_m[O_SCORE][s] = score;
    s_key[s] = rank_key(score, s);
  }
  const int nv = __syncthreads_count(vis_here);

  // ---- the rank: part p of slot j counts the slots i = p, p + 4, ... whose key is larger
  for (int e = t; e < K7_PARTS * MF; e += nt) {
    const int p = e / MF, j = e - p * MF;
    const unsigned long long kj = s_key[j];
    int cnt = 0;
    for (int i = p; i < MF; i += K7_PARTS) cnt += s_key[i] > kj;
    if (cnt) atomicAdd(&s_rank[j], cnt);
  }
  if (rows != nullptr)
    for (int e = t; e < NOUT * MF; e += nt) {
      const int k = e / MF, s = e - k * MF;
      rows[((size_t)lane * NOUT + k) * MF + s] = s_m[k][s];
    }
  __syncthreads();

  // ---- the selected rows, each written by its slot's thread
  if (t < MF && s_rank[t] < NSEL) {
    const int s = t, BN = gridDim.x * NSEL, o = lane * NSEL + s_rank[t];
    iout[o] = s;
    fout[SEL_SCORE * BN + o] = s_m[O_SCORE][s];
    for (int k = 0; k < 2; ++k) fout[SEL_H * BN + 2 * o + k] = s_m[O_H + k][s];
    for (int k = 0; k < 14; ++k) fout[SEL_HX * BN + 14 * o + k] = s_m[O_HX + k][s];
    for (int k = 0; k < 6; ++k) fout[SEL_HY * BN + 6 * o + k] = s_m[O_HY + k][s];
    fout[SEL_RD * BN + o] = s_m[O_RD][s];
    fout[SEL_S * BN + 4 * o] = s_m[O_S][s];
    fout[SEL_S * BN + 4 * o + 1] = s_m[O_S + 1][s];
    fout[SEL_S * BN + 4 * o + 2] = s_m[O_S + 1][s];
    fout[SEL_S * BN + 4 * o + 3] = s_m[O_S + 2][s];
    for (int k = 0; k < 3; ++k) fout[SEL_SINV * BN + 3 * o + k] = s_m[O_SINV + k][s];
  }
  if (t == 0) iout[gridDim.x * NSEL + lane] = nv;
}

// x [B, D], P [B, D, D], xp_org [B, MF, 7] f32 and active, full [B, MF]
// bytes, all contiguous. fout: B * NSEL * N_SEL_F floats (SEL_* layout);
// iout: top_idx [B, NSEL] then n_visible [B]; rows: [B, NOUT, MF] or null.
extern "C" int k7_measure_select(const float* x, const float* P, const float* xp_org,
                                 const uint8_t* active, const uint8_t* full, float* fout, int* iout,
                                 float* rows, int B, int D, int MF, int NSEL, const MeasConsts* c,
                                 void* stream) {
  if (MF < 1 || MF > K7_MAX_MF || NSEL < 1 || NSEL > MF || D < 13 + 6 * MF) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const int threads = K7_PARTS * 32 * ((MF + 31) / 32);
  k7_kernel<<<B, threads, 0, (cudaStream_t)stream>>>(x, P, xp_org, active, full, D, MF, NSEL, fout, iout,
                                                      rows, *c);
  return (int)cudaGetLastError();
}
