// The joint EKF update on a thread-block cluster, from L^-1 of S on: the
// phases that K3 (ekf_update.cu) and K15 (ekf_update_dense.cu) share.
//
// The part of scenelib2_tpu/kernels/pallas_ekf.py that its two update
// kernels share (_update_kernel, pallas_ekf.py:39-114, and
// _update_kernel_compact): S^-1 = L^-T L^-1, W = P H' S^-1, x' = x + W nu,
// P' = P - (W S) W', then P' transformed by the reference's qq=|q|^2
// quaternion-norm Jacobian (monoslam.cpp:616-637), the keep mask as a
// multiply and P/2 + P'/2. The plain PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::update_tail (then the twins'
// select, mask and symmetrize); every sum runs left to right in the same
// order there and here (built with -fmad=false).
//
// A launch is one cluster of UC_CLUSTER CTAs of UC_THREADS threads. CTA 0
// forms S and X = L^-1 (each kernel its own way), then calls uc_from_linv:
// S^-1, W, x', W S and the strips of the transform, the D x M arrays kept
// transposed ([m][Dp]) so that lanes read consecutive words, publishing W',
// (W S)', cols and rowsb at uc_pub's offsets of the workspace; after
// cluster.sync() the other CTAs copy them in (uc_copy_in: L2 reads; one SM
// serving seven readers over distributed shared memory would be slower)
// and every CTA forms its share of the T x T tiles of the upper triangle
// (uc_tiles): P[I][J] and P[J][I] staged in padded shared memory (coalesced
// both ways), each P'[i][j] and P'[j][i] by the same left-to-right sum
// over m (each thread RPT rows i x CPT columns j: per m, CPT conflict-free
// words of W' and (W S)' at j and two broadcast vectors at i), rows and
// columns 3..6 from rowsb / cols, the keep mask, and both halves of the
// result written back through the staged tiles (no transposed global
// read-back). Each thread's entries of its next tile are loaded into
// registers while the current one is formed (the first from the kernel's
// start, uc_fetch).
//
// The tile's result: UC_SYM (K3) P/2 + P'/2 with P' the transpose; UC_COUNT
// (K15's first pass) the same, counting each column's non-finite entries
// of the masked P into shared counters; UC_RULE (K15, once the counts of
// the whole matrix are known) P/2 + T/2 with T the TPU kernel's product by
// the identity: T[i][j] = NaN where column i holds a non-finite entry in a
// row other than j, else P[j][i] (ekf_update.py::transpose_by_identity).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include "chol_linv.cuh"

namespace cg = cooperative_groups;

#ifndef UPD_MARK
#define UPD_MARK(k, thread)  // a phase boundary: scripts/k3_timeline.py stamps the time there
#endif

#define UC_THREADS 512
#define UC_CLUSTER 8  // portable cluster size

enum UcMode { UC_SYM = 0, UC_COUNT = 1, UC_RULE = 2 };

// offsets (floats) of what CTA 0 publishes, in the workspace and in every
// CTA's dynamic shared memory: W' [M][Dp], (W S)' [M][Dp], cols [Dp][4],
// rowsb [4][Dp]; end: the floats of all four (a multiple of 4)
struct UcPub {
  int Wt, WSt, cols, rowsb, end;
};

__host__ __device__ inline UcPub uc_pub(int Dp, int M) {
  UcPub p;
  p.Wt = 0;
  p.WSt = M * Dp;
  p.cols = 2 * M * Dp;
  p.rowsb = p.cols + 4 * Dp;
  p.end = p.rowsb + 4 * Dp;
  return p;
}

// out'[n][d] = sum_m in'[m][d] mat[m][n], m ascending (in' and out' are
// [M][Dp], D x M matrices stored transposed; mat is [M][Mp]), into shared
// memory and the workspace, 0 past D: a thread four columns n of a row d
__device__ inline void uc_right_product(const float* in, const float* mat, float* out, float* out_ws, int D,
                                        int Dp, int M, int Mp) {
  for (int e = threadIdx.x; e < (Mp / 4) * Dp; e += blockDim.x) {
    const int n0 = 4 * (e / Dp), d = e - (e / Dp) * Dp;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (d < D) {
      for (int m = 0; m < M; ++m) {
        const float v = in[m * Dp + d];
        const float4 s4 = *reinterpret_cast<const float4*>(mat + m * Mp + n0);
        acc[0] = m == 0 ? v * s4.x : acc[0] + v * s4.x;
        acc[1] = m == 0 ? v * s4.y : acc[1] + v * s4.y;
        acc[2] = m == 0 ? v * s4.z : acc[2] + v * s4.z;
        acc[3] = m == 0 ? v * s4.w : acc[3] + v * s4.w;
      }
    }
    for (int q = 0; q < 4 && n0 + q < M; ++q) out[(n0 + q) * Dp + d] = out_ws[(n0 + q) * Dp + d] = acc[q];
  }
}

// CTA 0, every thread, once X = L^-1 [M][M] is final (after a barrier):
// S^-1 = L^-T L^-1 into Sinv [M][Mp]; W' = (P H' S^-1)' from PHt [M][Dp];
// x' = x + W nu into xu; (W S)' from S [M][Mp]; the strips of P' in rows
// and columns 3..6 and from them the transform's columns (cols) and rows
// (rowsb). W', (W S)', cols and rowsb go to dyn and ws at uc_pub's offsets.
__device__ inline void uc_from_linv(const float* __restrict__ x, const float* __restrict__ P, const float* nu,
                                    const float* S, const float* X, float* Sinv, const float* PHt, float* dyn,
                                    float* xu, float* ws, int D, int Dp, int M, int Mp) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const UcPub pub = uc_pub(Dp, M);
  float* Wt = dyn + pub.Wt;
  float* WSt = dyn + pub.WSt;
  float* cols = dyn + pub.cols;
  float* rowsb = dyn + pub.rowsb;
  // ---- S^-1 = L^-T L^-1
  for (int e = tid; e < M * Mp; e += nt) {
    const int i = e / Mp, j = e - i * Mp;
    float acc = 0.0f;
    if (j < M) {
      acc = X[i] * X[j];
      for (int k = 1; k < M; ++k) acc = acc + X[k * M + i] * X[k * M + j];
    }
    Sinv[e] = acc;
  }
  __syncthreads();
  UPD_MARK(7, 0);
  // ---- W = P H' S^-1
  uc_right_product(PHt, Sinv, Wt, ws + pub.Wt, D, Dp, M, Mp);
  __syncthreads();
  UPD_MARK(8, 0);
  // ---- x' = x + W nu;  W S
  for (int d = tid; d < D; d += nt) {
    float acc = nu[0] * Wt[d];
    for (int m = 1; m < M; ++m) acc = acc + nu[m] * Wt[m * Dp + d];
    xu[d] = x[d] + acc;
  }
  uc_right_product(Wt, S, WSt, ws + pub.WSt, D, Dp, M, Mp);
  __syncthreads();
  UPD_MARK(9, 0);
  // ---- the quaternion-norm Jacobian with the qq=|q|^2 quirk
  const float q[4] = {xu[3], xu[4], xu[5], xu[6]};
  const float qq = q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3];
  float J[4][4];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c)
      J[r][c] = r == c ? (1.0f - q[c] * q[c] / (qq * qq)) / qq : -(q[r] * q[c]) / (qq * qq * qq);
  // ---- the strips of P': row d's columns 3..6 (cs), whose transform
  // cols[d] = P'[d][3..6] J' is final, and column d's rows 3..6, parked
  // in rowsb[.][d] until every row of cols is in
  for (int d = tid; d < Dp; d += nt) {
    float cs[4] = {0.0f, 0.0f, 0.0f, 0.0f}, r4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (d < D) {
      for (int k = 0; k < 4; ++k) {
        cs[k] = WSt[d] * Wt[3 + k];
        r4[k] = WSt[3 + k] * Wt[d];
      }
      for (int m = 1; m < M; ++m) {
        const float wsd = WSt[m * Dp + d], wd = Wt[m * Dp + d];
        for (int k = 0; k < 4; ++k) {
          cs[k] = cs[k] + wsd * Wt[m * Dp + 3 + k];
          r4[k] = r4[k] + WSt[m * Dp + 3 + k] * wd;
        }
      }
      for (int k = 0; k < 4; ++k) {
        cs[k] = P[(size_t)d * D + 3 + k] - cs[k];
        r4[k] = P[(size_t)(3 + k) * D + d] - r4[k];
      }
    }
    float4 c4;
    float* cv = &c4.x;
    for (int c = 0; c < 4; ++c) {
      float acc = cs[0] * J[c][0];
      for (int k = 1; k < 4; ++k) acc = acc + cs[k] * J[c][k];
      cv[c] = acc;
    }
    *reinterpret_cast<float4*>(cols + 4 * d) = c4;
    *reinterpret_cast<float4*>(ws + pub.cols + 4 * d) = c4;
    for (int k = 0; k < 4; ++k) rowsb[k * Dp + d] = r4[k];
  }
  __syncthreads();
  UPD_MARK(10, 0);
  // ---- rowsb[r][d] = J[r] . (P' with columns 3..6 replaced by cols)[3..6][d]
  for (int d = tid; d < Dp; d += nt) {
    float pt[4];
    for (int k = 0; k < 4; ++k) pt[k] = (d >= 3 && d < 7) ? cols[(3 + k) * 4 + (d - 3)] : rowsb[k * Dp + d];
    for (int r = 0; r < 4; ++r) {
      float acc = 0.0f;
      for (int k = 0; k < 4; ++k) {
        const float t = J[r][k] * pt[k];
        acc = k == 0 ? t : acc + t;
      }
      rowsb[r * Dp + d] = acc;  // column d is this thread's alone
      ws[pub.rowsb + r * Dp + d] = acc;
    }
  }
  UPD_MARK(11, 0);
}

// after cluster.sync(): the published arrays (uc_pub's first `end` floats)
// from the workspace into this CTA's shared memory
__device__ inline void uc_copy_in(float4* dst, const float* ws, int end) {
  const float4* src = reinterpret_cast<const float4*>(ws);
#pragma unroll 8
  for (int e = threadIdx.x; e < end / 4; e += blockDim.x) dst[e] = __ldcg(src + e);
}

// a tile side's per-thread shape: RPT rows (a warp's share) x CPT columns
// (lane, lane + 32, ...), TP the padded pitch of a staged tile
template <int T>
struct UcTile {
  static constexpr int RPT = T / (UC_THREADS / 32);
  static constexpr int CPT = T / 32;
  static constexpr int TP = T + 1;
};

// tile t (I <= J, row-major over the upper triangle of nT x nT tiles)
__device__ __forceinline__ void uc_tile(int t, int nT, int* I, int* J) {
  int i = 0;
  while (t >= nT - i) {
    t -= nT - i;
    ++i;
  }
  *I = i;
  *J = i + t;
}

// this thread's entries of tile t: pa[rr][cc] = P[I0 + r0 + rr][J0 + lane
// + 32 cc] and (off the diagonal) pb[rr][cc] = P[J0 + r0 + rr][I0 + lane +
// 32 cc], 0 outside P
template <int T>
__device__ __forceinline__ void uc_fetch(const float* __restrict__ P, int D, int nT, int t, int r0, int lane,
                                         float (&pa)[UcTile<T>::RPT][UcTile<T>::CPT],
                                         float (&pb)[UcTile<T>::RPT][UcTile<T>::CPT]) {
  int I, J;
  uc_tile(t, nT, &I, &J);
  const int I0 = I * T, J0 = J * T;
#pragma unroll
  for (int rr = 0; rr < UcTile<T>::RPT; ++rr) {
#pragma unroll
    for (int cc = 0; cc < UcTile<T>::CPT; ++cc) {
      const int r = r0 + rr, c = lane + 32 * cc;
      pa[rr][cc] = (I0 + r < D && J0 + c < D) ? P[(size_t)(I0 + r) * D + J0 + c] : 0.0f;
      pb[rr][cc] = (I != J && J0 + r < D && I0 + c < D) ? P[(size_t)(J0 + r) * D + I0 + c] : 0.0f;
    }
  }
}

// RPT consecutive floats at p (a vector load: p is aligned to RPT words)
__device__ __forceinline__ void uc_rows(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}
__device__ __forceinline__ void uc_rows(const float* p, float (&v)[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x;
  v[1] = t.y;
}

// Every UC_CLUSTER-th T x T tile of the upper triangle from `rank` on (see
// the header): dyn holds the published arrays, keep [Dp] the keep factors,
// Pa two staged tiles; pa / pb hold this thread's entries of the first
// tile (uc_fetch). any: whether the update applies (else P passes through
// untransformed). cnt [Dp]: UC_COUNT adds each column's non-finite entries
// of the masked P there; UC_RULE reads the whole matrix's counts there.
template <int T, int MODE>
__device__ inline void uc_tiles(const float* __restrict__ P, float* __restrict__ Po, int D, int Dp, int M,
                                bool any, const float* dyn, const float* keep, float* Pa, int rank,
                                float (&pa)[UcTile<T>::RPT][UcTile<T>::CPT],
                                float (&pb)[UcTile<T>::RPT][UcTile<T>::CPT], int* cnt) {
  constexpr int RPT = UcTile<T>::RPT, CPT = UcTile<T>::CPT, TP = UcTile<T>::TP;
  const UcPub pub = uc_pub(Dp, M);
  const float* Wt = dyn + pub.Wt;
  const float* WSt = dyn + pub.WSt;
  const float* cols = dyn + pub.cols;
  const float* rowsb = dyn + pub.rowsb;
  const int tid = threadIdx.x, lane = tid & 31, r0 = RPT * (tid >> 5);
  const int nT = Dp / T, n_tiles = nT * (nT + 1) / 2;
  float* Pb = Pa + T * TP;  // Pa: P[I0 + r][J0 + c] at r * TP + c; Pb: P[J0 + r][I0 + c]
  for (int t = rank; t < n_tiles; t += UC_CLUSTER) {
    int I, J;
    uc_tile(t, nT, &I, &J);
    const int I0 = I * T, J0 = J * T;
    const bool diag = I == J;
    for (int rr = 0; rr < RPT; ++rr)
      for (int cc = 0; cc < CPT; ++cc) {
        Pa[(r0 + rr) * TP + lane + 32 * cc] = pa[rr][cc];
        Pb[(r0 + rr) * TP + lane + 32 * cc] = pb[rr][cc];
      }
    __syncthreads();
    // the next tile's loads fly while this one is formed
    if (t + UC_CLUSTER < n_tiles) uc_fetch<T>(P, D, nT, t + UC_CLUSTER, r0, lane, pa, pb);
    // P'[i][j] = P[i][j] - sum_m WS[i][m] W[j][m], m ascending, and P'[j][i]:
    // rows i = I0 + r0 + rr, columns j = J0 + lane + 32 cc
    float aij[RPT][CPT] = {}, aji[RPT][CPT] = {};
    if (any) {
      for (int m = 0; m < M; ++m) {
        const float* wm = Wt + m * Dp;
        const float* sm = WSt + m * Dp;
        float wj[CPT], wsj[CPT], wi[RPT], wsi[RPT];
#pragma unroll
        for (int cc = 0; cc < CPT; ++cc) {
          wj[cc] = wm[J0 + lane + 32 * cc];
          wsj[cc] = sm[J0 + lane + 32 * cc];
        }
        uc_rows(wm + I0 + r0, wi);
        uc_rows(sm + I0 + r0, wsi);
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
          for (int cc = 0; cc < CPT; ++cc) {
            aij[rr][cc] = m == 0 ? wsi[rr] * wj[cc] : aij[rr][cc] + wsi[rr] * wj[cc];
            aji[rr][cc] = m == 0 ? wsj[cc] * wi[rr] : aji[rr][cc] + wsj[cc] * wi[rr];
          }
      }
    }
    float oij[RPT][CPT], oji[RPT][CPT];
    for (int rr = 0; rr < RPT; ++rr)
      for (int cc = 0; cc < CPT; ++cc) {
        const int i = I0 + r0 + rr, c = lane + 32 * cc, j = J0 + c;
        float pij = Pa[(r0 + rr) * TP + c];
        float pji = diag ? Pa[c * TP + r0 + rr] : Pb[c * TP + r0 + rr];
        if (any) {
          // the transform: rows 3..6 from rowsb, else columns 3..6 from cols
          pij = (i >= 3 && i < 7)   ? rowsb[(i - 3) * Dp + j]
                : (j >= 3 && j < 7) ? cols[4 * i + (j - 3)]
                                    : pij - aij[rr][cc];
          pji = (j >= 3 && j < 7)   ? rowsb[(j - 3) * Dp + i]
                : (i >= 3 && i < 7) ? cols[4 * j + (i - 3)]
                                    : pji - aji[rr][cc];
        }
        const float k2 = keep[i] * keep[j];
        const float a = pij * k2, b = pji * k2;  // P[i][j], P[j][i] masked
        if (MODE == UC_RULE) {
          const float qnan = __int_as_float(0x7fffffff);
          oij[rr][cc] = a * 0.5f + ((cnt[i] - (isfinite(b) ? 0 : 1)) > 0 ? qnan : b) * 0.5f;
          oji[rr][cc] = b * 0.5f + ((cnt[j] - (isfinite(a) ? 0 : 1)) > 0 ? qnan : a) * 0.5f;
        } else {
          oij[rr][cc] = a * 0.5f + b * 0.5f;
          oji[rr][cc] = b * 0.5f + a * 0.5f;
        }
        if (MODE == UC_COUNT && i < D && j < D) {
          if (!isfinite(a)) atomicAdd(cnt + j, 1);
          if (!diag && !isfinite(b)) atomicAdd(cnt + i, 1);
        }
      }
    __syncthreads();
    for (int rr = 0; rr < RPT; ++rr)
      for (int cc = 0; cc < CPT; ++cc) {
        const int c = lane + 32 * cc;
        Pa[(r0 + rr) * TP + c] = oij[rr][cc];
        if (!diag) Pb[c * TP + r0 + rr] = oji[rr][cc];
      }
    __syncthreads();
    for (int rr = 0; rr < RPT; ++rr)
      for (int cc = 0; cc < CPT; ++cc) {
        const int r = r0 + rr, c = lane + 32 * cc;
        if (I0 + r < D && J0 + c < D) Po[(size_t)(I0 + r) * D + J0 + c] = Pa[r * TP + c];
        if (!diag && J0 + r < D && I0 + c < D) Po[(size_t)(J0 + r) * D + I0 + c] = Pb[r * TP + c];
      }
    __syncthreads();
  }
}
