// K3: fused joint EKF update + quaternion-norm transform + feature bookkeeping
//     + delete + symmetrize.
//
// Replaces scenelib2_tpu/kernels/pallas_ekf.py
// (pallas_joint_update_norm_compact / _update_kernel_compact, with
// pallas_linalg.py::chol_linv_body). The plain PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::joint_update_plain; every sum runs
// in the same order there and here (built with -fmad=false), so the two
// agree bit for bit.
//
// Bound on an H100: P in and out (0.1 MB at D = 109, 1.1 MB at D = 373) and
// D^2 M multiply-adds (2.8 M at D = 373, M = 20): under a microsecond. What
// costs is latency: the 2M dependent factorisation / substitution steps and
// the launch. Design: ONE launch, a thread-block cluster of K3_CLUSTER CTAs
// of 512 threads, three phases:
//   1. CTA 0, the O(D M^2 + M^3) prefix: H (never formed: 10 non-zeros a
//      row, read from K1's selected columns), nu, R; P H' at the 7 + 3 NSEL
//      rows that H reads, which is all S needs; S; then L^-1 by
//      chol_linv.cuh in one warp's registers (at the M the build fixed,
//      CHOL_REG_M; the whole block at any other M), the chain of M dependent
//      steps that sets this phase's length, while the other 15 warps gather
//      the 7 + 3 NSEL columns of P that H reads and form P H' at every row;
//      S^-1; W = P H' S^-1; x'; W S;
//      the strips of P' = P - (W S) W' in rows and columns 3..6 and from
//      them the quaternion-norm transform's columns (cols) and rows (rowsb).
//      D x M arrays are kept transposed ([m][d]) so that lanes read
//      consecutive words. CTA 1, meanwhile: the bookkeeping and the kill
//      mask. Both publish what the others need (W', (W S)', cols, rowsb, the
//      keep factors, the any-match flag) to a global workspace that the
//      wrapper allocates.
//   2. cluster.sync() (release / acquire at cluster scope); every CTA copies
//      the workspace into its shared memory (L2 reads: one SM serving seven
//      readers over distributed shared memory would be slower).
//   3. Every CTA takes every K3_CLUSTER-th 64 x 64 tile (I <= J) of the upper
//      triangle of P. It stages P[I][J] and P[J][I] in padded shared memory
//      (coalesced both ways), forms each P'[i][j] and P'[j][i] with the same
//      left-to-right sum over m (each thread 4 rows i x 2 columns j, lane
//      and lane + 32: per m, 4 conflict-free words of W' and (W S)' at j and
//      two broadcast float4 at i for 16 products each way), overwrites rows and columns 3..6 from rowsb / cols,
//      applies the keep mask and writes both halves of P/2 + P'/2 back
//      through the staged tiles. No transposed global read-back. Each
//      thread's entries of its next tile are loaded into registers while
//      the current one is formed (the first from the kernel's start).
// With no match at all, P passes through untransformed, as before. Labels
// are ranked as int32 (the TPU kernel ranked them as f32).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "chol_linv.cuh"

namespace cg = cooperative_groups;

#define CAM_DIM 13
#define SLOT_DIM 6
#define MAX_M 64
#define MAX_MF 256
#define K3_THREADS 512
#define K3_CLUSTER 8   // portable cluster size
#define K3_T 64        // tile side
#define K3_TP 65       // padded pitch of a staged tile
#define K3_RPT 4       // tile rows a thread: K3_T / (K3_THREADS / 32); its columns: lane, lane + 32

// measure.py row layout
#define O_H 0
#define O_HX 2
#define O_HY 16
#define O_RD 22

struct K3Params {
  float min_attempts, success_fraction;
};

// the kernel's shared arrays (floats, each a multiple of 4 so that every
// array starts 16-byte aligned), and the workspace's (the first five)
struct K3Layout {
  int Dp, Mp;                      // D rounded up to the tile, M up to 4
  int Wt, WSt, cols, rowsb, keep;  // W' [M][Dp], (W S)' [M][Dp], cols [Dp][4], rowsb [4][Dp], keep [Dp]
  int flag;                        // workspace only: the any-match flag [4]
  int xu, R, S, Sinv, A, U, X;     // shared only: x' [Dp]; P H' [M][Dp] or two tiles; S, S^-1 [M][Mp]; A, U, X [M][M]
  int PHs;                         // shared only: P H' at the rows H reads [7 + 3 NSEL][M]
  int n_ws, n_smem;
};

__host__ __device__ inline K3Layout k3_layout(int D, int M) {
  K3Layout L;
  L.Dp = (D + K3_T - 1) / K3_T * K3_T;
  L.Mp = (M + 3) / 4 * 4;
  int o = 0;
  L.Wt = o; o += M * L.Dp;
  L.WSt = o; o += M * L.Dp;
  L.cols = o; o += 4 * L.Dp;
  L.rowsb = o; o += 4 * L.Dp;
  L.keep = o; o += L.Dp;
  L.flag = o;
  L.n_ws = o + 4;
  L.xu = o; o += L.Dp;
  L.R = o;
  const int tiles = 2 * K3_T * K3_TP;
  o += M * L.Dp > tiles ? M * L.Dp : tiles;
  L.S = o; o += M * L.Mp;
  L.Sinv = o; o += M * L.Mp;
  L.A = o; o += M * M;
  L.U = o; o += M * M;
  L.X = o; o += M * M;
  L.PHs = o; o += ((7 + 3 * (M / 2)) * M + 3) / 4 * 4;
  L.n_smem = o;
  return L;
}

// tile t (I <= J, row-major over the upper triangle of nT x nT tiles)
__device__ __forceinline__ void k3_tile(int t, int nT, int* I, int* J) {
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
__device__ __forceinline__ void k3_fetch(const float* __restrict__ P, int D, int nT, int t, int r0, int lane,
                                         float pa[K3_RPT][2], float pb[K3_RPT][2]) {
  int I, J;
  k3_tile(t, nT, &I, &J);
  const int I0 = I * K3_T, J0 = J * K3_T;
#pragma unroll
  for (int rr = 0; rr < K3_RPT; ++rr) {
#pragma unroll
    for (int cc = 0; cc < 2; ++cc) {
      const int r = r0 + rr, c = lane + 32 * cc;
      pa[rr][cc] = (I0 + r < D && J0 + c < D) ? P[(size_t)(I0 + r) * D + J0 + c] : 0.0f;
      pb[rr][cc] = (I != J && J0 + r < D && I0 + c < D) ? P[(size_t)(J0 + r) * D + I0 + c] : 0.0f;
    }
  }
}

// out'[n][d] = sum_m in'[m][d] mat[m][n], m ascending (in' and out' are
// [M][Dp], D x M matrices stored transposed; mat is [M][Mp]), into shared
// memory and the workspace, 0 past D: a thread four columns n of a row d
__device__ inline void k3_right_product(const float* in, const float* mat, float* out, float* out_ws, int D,
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

__global__ void __launch_bounds__(K3_THREADS)
k3_kernel(const float* __restrict__ x, const float* __restrict__ P, const float* __restrict__ sel,
          const float* __restrict__ z, const uint8_t* __restrict__ succ,
          const int* __restrict__ offs, const int* __restrict__ attempts,
          const int* __restrict__ successes, const uint8_t* __restrict__ sched,
          const uint8_t* __restrict__ active, const int* __restrict__ label,
          const uint8_t* __restrict__ sel_mask, const int* __restrict__ top_idx,
          float* __restrict__ xo, float* __restrict__ Po, int* __restrict__ att_o,
          int* __restrict__ suc_o, uint8_t* __restrict__ sch_o, uint8_t* __restrict__ kill_o,
          float* ws, int D, int NSEL, int MF, K3Params p) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int M = 2 * NSEL;
  const K3Layout L = k3_layout(D, M);
  const int Dp = L.Dp, Mp = L.Mp;
  float* Wt = dyn + L.Wt;
  float* WSt = dyn + L.WSt;
  float* cols = dyn + L.cols;
  float* rowsb = dyn + L.rowsb;
  float* keep = dyn + L.keep;
  const int tid = threadIdx.x, nt = blockDim.x;
  // phase 3's first tile of P, in flight from the start (P is an input)
  const int nT = Dp / K3_T, n_tiles = nT * (nT + 1) / 2;
  const int lane = tid & 31, r0 = K3_RPT * (tid >> 5);  // lanes: columns; a warp: K3_RPT rows
  float pa[K3_RPT][2] = {}, pb[K3_RPT][2] = {};
  if (rank < n_tiles) k3_fetch(P, D, nT, rank, r0, lane, pa, pb);

  if (rank == 0) {
    // ================= phase 1, CTA 0: the update's prefix
    float* xu = dyn + L.xu;
    float* PHt = dyn + L.R;        // (P H')' [M][Dp]
    float* S = dyn + L.S;          // [M][Mp]
    float* Sinv = dyn + L.Sinv;    // [M][Mp]
    float* A = dyn + L.A;          // [M][M]
    float* U = dyn + L.U;
    float* X = dyn + L.X;
    __shared__ float hx[MAX_M][7], hy[MAX_M][3], nu[MAX_M], rd[MAX_M];
    __shared__ int offm[MAX_M], any_s;
    // ---- H, nu, R from the selected columns (failed rows: H=0, nu=0, R=1)
    if (tid < M) {
      const int k = tid >> 1, i = tid & 1;
      const float sf = succ[k] ? 1.0f : 0.0f;
      for (int a = 0; a < 7; ++a) hx[tid][a] = sel[(O_HX + 7 * i + a) * NSEL + k] * sf;
      for (int j = 0; j < 3; ++j) hy[tid][j] = sel[(O_HY + 3 * i + j) * NSEL + k] * sf;
      nu[tid] = sf * (z[2 * k + i] - sel[(O_H + i) * NSEL + k]);
      rd[tid] = succ[k] ? sel[O_RD * NSEL + k] : 1.0f;
      offm[tid] = offs[k];
    }
    if (tid == 0) {
      int a = 0;
      for (int k = 0; k < NSEL; ++k) a |= succ[k] != 0;
      any_s = a;
      ws[L.flag] = a ? 1.0f : 0.0f;
    }
    __syncthreads();
    if (any_s) {
      // the state dims H reads, in its order: 0..6, then each selection's
      // slot offs[k] .. offs[k] + 2 (a row index of P as well as a column)
      const int NC = 7 + 3 * NSEL, Pp = Dp + 1;
      __shared__ int colk[7 + 3 * (MAX_M / 2)];
      for (int k = tid; k < NC; k += nt) colk[k] = k < 7 ? k : offs[(k - 7) / 3] + (k - 7) % 3;
      __syncthreads();
      // ---- P H' at the rows H reads, all that S needs (from P directly)
      float* PHs = dyn + L.PHs;  // [NC][M]: row colk[r] of P H'
      for (int e = tid; e < NC * M; e += nt) {
        const int r = e / M, m = e - r * M;
        const float* Pr = P + (size_t)colk[r] * D;
        float acc = Pr[0] * hx[m][0];
        for (int a = 1; a < 7; ++a) acc = acc + Pr[a] * hx[m][a];
        for (int j = 0; j < 3; ++j) acc = acc + Pr[offm[m] + j] * hy[m][j];
        PHs[e] = acc;
      }
      __syncthreads();
      // ---- S = H P H' + R (lanes along m)
      for (int e = tid; e < M * Mp; e += nt) {
        const int n = e / M, m = e - n * M;
        if (n >= M) {
          S[m * Mp + n] = 0.0f;  // S's pad columns, n in [M, Mp)
          continue;
        }
        const int ks = 7 + 3 * (m >> 1);
        float acc = hx[m][0] * PHs[n];
        for (int a = 1; a < 7; ++a) acc = acc + hx[m][a] * PHs[a * M + n];
        for (int j = 0; j < 3; ++j) acc = acc + hy[m][j] * PHs[(ks + j) * M + n];
        const float sv = acc + (m == n ? rd[m] : 0.0f);
        S[m * Mp + n] = sv;
        A[m * M + n] = sv;
        U[m * M + n] = 0.0f;
      }
      __syncthreads();
      // ---- X = L^-1 (chol_linv.cuh) on warp 0 where M has the register
      // form (the build's CHOL_REG_M) while the other warps gather the
      // columns of P that H reads into Pc [NC][Dp + 1] (a thread a row, 16
      // loads in flight; the odd pitch keeps the stores and the reads free of
      // bank conflicts; Pc is parked in the W' .. rowsb region, which W
      // overwrites later) and form P H' at every row; at any other M the
      // whole block gathers, then factorises
      const bool split = chol_linv_reg_sized(M);
      if (split && tid < 32) {
        chol_linv_reg_any(A, X, M);
      } else {
        const int t0 = split ? tid - 32 : tid, n0 = split ? nt - 32 : nt;
        float* Pc = Wt;
        for (int d = t0; d < D; d += n0) {
          const float* Pr = P + (size_t)d * D;
          for (int k0 = 0; k0 < NC; k0 += 16) {
            float v[16];
#pragma unroll
            for (int k = 0; k < 16; ++k) v[k] = k0 + k < NC ? Pr[colk[k0 + k]] : 0.0f;
#pragma unroll
            for (int k = 0; k < 16; ++k)
              if (k0 + k < NC) Pc[(k0 + k) * Pp + d] = v[k];
          }
        }
        if (split)
          asm volatile("bar.sync 1, %0;" ::"r"(n0));  // the gathering warps only
        else
          __syncthreads();
        // P H' (state dims ascending over H's non-zeros), lanes along d
        for (int e = t0; e < M * Dp; e += n0) {
          const int m = e / Dp, d = e - m * Dp;
          float acc = 0.0f;
          if (d < D) {
            const float* pk = Pc + d;
            const int ks = 7 + 3 * (m >> 1);
            acc = pk[0] * hx[m][0];
            for (int a = 1; a < 7; ++a) acc = acc + pk[a * Pp] * hx[m][a];
            for (int j = 0; j < 3; ++j) acc = acc + pk[(ks + j) * Pp] * hy[m][j];
          }
          PHt[e] = acc;
        }
      }
      __syncthreads();
      if (!split) {
        chol_linv_block(A, U, X, M);
        __syncthreads();
      }
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
      // ---- W = P H' S^-1
      k3_right_product(PHt, Sinv, Wt, ws + L.Wt, D, Dp, M, Mp);
      __syncthreads();
      // ---- x' = x + W nu;  W S
      for (int d = tid; d < D; d += nt) {
        float acc = nu[0] * Wt[d];
        for (int m = 1; m < M; ++m) acc = acc + nu[m] * Wt[m * Dp + d];
        xu[d] = x[d] + acc;
      }
      k3_right_product(Wt, S, WSt, ws + L.WSt, D, Dp, M, Mp);
      __syncthreads();
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
        *reinterpret_cast<float4*>(ws + L.cols + 4 * d) = c4;
        for (int k = 0; k < 4; ++k) rowsb[k * Dp + d] = r4[k];
      }
      __syncthreads();
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
          ws[L.rowsb + r * Dp + d] = acc;
        }
      }
    } else {
      // no match at all: the prior passes through
      for (int d = tid; d < D; d += nt) xu[d] = x[d];
    }
    __threadfence();
  } else if (rank == 1) {
    // ================= phase 1, CTA 1: bookkeeping (monoslam.cpp:644-703)
    __shared__ int att_s[MAX_MF], suc_s[MAX_MF], order_s[MAX_MF];
    __shared__ uint8_t sch1_s[MAX_MF], kill_s[MAX_MF];
    for (int i = tid; i < MF; i += nt) {
      int att = attempts[i], suc = successes[i];
      for (int k = 0; k < NSEL; ++k)
        if (top_idx[k] == i) {
          att += sel_mask[k] ? 1 : 0;
          suc += succ[k] ? 1 : 0;
        }
      const float fatt = (float)att;
      const float ratio = att > 0 ? (float)suc / fmaxf(fatt, 1.0f) : 1.0f;
      const bool act = active[i] != 0;
      const bool bad = act && fatt >= p.min_attempts && ratio < p.success_fraction;
      att_s[i] = att;
      suc_s[i] = suc;
      sch1_s[i] = ((sched[i] != 0) || bad) && act;
      // list position: stable rank of (label if active else 2^30, slot)
      const int key = act ? label[i] : (1 << 30);
      int rank_i = 0;
      for (int j = 0; j < MF; ++j) {
        const int kj = active[j] ? label[j] : (1 << 30);
        rank_i += (kj < key) || (kj == key && j < i);
      }
      order_s[rank_i] = i;
    }
    __syncthreads();
    // within each run of consecutively scheduled list positions, even run
    // offsets die this frame (the exterminate iterator skip)
    for (int pos = tid; pos < MF; pos += nt) {
      int run_start = 0;
      for (int q2 = 0; q2 <= pos; ++q2) {
        const int t = sch1_s[order_s[q2]] ? 0 : q2 + 1;
        run_start = t > run_start ? t : run_start;
      }
      const int slot = order_s[pos];
      kill_s[slot] = sch1_s[slot] && ((pos - run_start) % 2 == 0);
    }
    __syncthreads();
    for (int i = tid; i < MF; i += nt) {
      att_o[i] = att_s[i];
      suc_o[i] = suc_s[i];
      sch_o[i] = sch1_s[i] && !kill_s[i];
      kill_o[i] = kill_s[i];
    }
    for (int d = tid; d < Dp; d += nt)
      ws[L.keep + d] = d >= D ? 0.0f : d < CAM_DIM ? 1.0f : (kill_s[(d - CAM_DIM) / SLOT_DIM] ? 0.0f : 1.0f);
    __threadfence();
  }

  // ================= phase 2: publish (cluster barrier), then copy in
  cluster.sync();
  const bool any = __ldcg(ws + L.flag) != 0.0f;
  for (int d = tid; d < Dp; d += nt) keep[d] = __ldcg(ws + L.keep + d);
  if (rank != 0 && any) {
    // W', (W S)', cols, rowsb: contiguous in the workspace and in shared memory
    const float4* src = reinterpret_cast<const float4*>(ws);
#pragma unroll 8
    for (int e = tid; e < (L.keep - L.Wt) / 4; e += nt) dyn4[e] = __ldcg(src + e);
  }
  __syncthreads();
  if (rank == 0)
    for (int d = tid; d < D; d += nt) xo[d] = dyn[L.xu + d] * keep[d];

  // ================= phase 3: the upper-triangle tiles of P/2 + P'/2
  float* Pa = dyn + L.R;               // P[I0 + r][J0 + c] at r * K3_TP + c
  float* Pb = Pa + K3_T * K3_TP;       // P[J0 + r][I0 + c]
  for (int t = rank; t < n_tiles; t += K3_CLUSTER) {
    int I, J;
    k3_tile(t, nT, &I, &J);
    const int I0 = I * K3_T, J0 = J * K3_T;
    const bool diag = I == J;
    for (int rr = 0; rr < K3_RPT; ++rr)
      for (int cc = 0; cc < 2; ++cc) {
        Pa[(r0 + rr) * K3_TP + lane + 32 * cc] = pa[rr][cc];
        Pb[(r0 + rr) * K3_TP + lane + 32 * cc] = pb[rr][cc];
      }
    __syncthreads();
    // the next tile's loads fly while this one is formed
    if (t + K3_CLUSTER < n_tiles) k3_fetch(P, D, nT, t + K3_CLUSTER, r0, lane, pa, pb);
    // P'[i][j] = P[i][j] - sum_m WS[i][m] W[j][m], m ascending, and P'[j][i]:
    // rows i = I0 + r0 + rr, columns j = J0 + lane + 32 cc
    float aij[K3_RPT][2] = {}, aji[K3_RPT][2] = {};
    if (any) {
      for (int m = 0; m < M; ++m) {
        const float* wm = Wt + m * Dp;
        const float* sm = WSt + m * Dp;
        const float wj[2] = {wm[J0 + lane], wm[J0 + lane + 32]};
        const float wsj[2] = {sm[J0 + lane], sm[J0 + lane + 32]};
        const float4 wi4 = *reinterpret_cast<const float4*>(wm + I0 + r0);
        const float4 wsi4 = *reinterpret_cast<const float4*>(sm + I0 + r0);
        const float wi[4] = {wi4.x, wi4.y, wi4.z, wi4.w};
        const float wsi[4] = {wsi4.x, wsi4.y, wsi4.z, wsi4.w};
#pragma unroll
        for (int rr = 0; rr < K3_RPT; ++rr)
#pragma unroll
          for (int cc = 0; cc < 2; ++cc) {
            aij[rr][cc] = m == 0 ? wsi[rr] * wj[cc] : aij[rr][cc] + wsi[rr] * wj[cc];
            aji[rr][cc] = m == 0 ? wsj[cc] * wi[rr] : aji[rr][cc] + wsj[cc] * wi[rr];
          }
      }
    }
    float oij[K3_RPT][2], oji[K3_RPT][2];
    for (int rr = 0; rr < K3_RPT; ++rr)
      for (int cc = 0; cc < 2; ++cc) {
        const int i = I0 + r0 + rr, c = lane + 32 * cc, j = J0 + c;
        float pij = Pa[(r0 + rr) * K3_TP + c];
        float pji = diag ? Pa[c * K3_TP + r0 + rr] : Pb[c * K3_TP + r0 + rr];
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
        const float a = pij * k2, b = pji * k2;
        oij[rr][cc] = a * 0.5f + b * 0.5f;
        oji[rr][cc] = b * 0.5f + a * 0.5f;
      }
    __syncthreads();
    for (int rr = 0; rr < K3_RPT; ++rr)
      for (int cc = 0; cc < 2; ++cc) {
        const int c = lane + 32 * cc;
        Pa[(r0 + rr) * K3_TP + c] = oij[rr][cc];
        if (!diag) Pb[c * K3_TP + r0 + rr] = oji[rr][cc];
      }
    __syncthreads();
    for (int rr = 0; rr < K3_RPT; ++rr)
      for (int cc = 0; cc < 2; ++cc) {
        const int r = r0 + rr, c = lane + 32 * cc;
        if (I0 + r < D && J0 + c < D) Po[(size_t)(I0 + r) * D + J0 + c] = Pa[r * K3_TP + c];
        if (!diag && J0 + r < D && I0 + c < D) Po[(size_t)(J0 + r) * D + I0 + c] = Pb[r * K3_TP + c];
      }
    __syncthreads();
  }
}

// floats of the workspace a call needs (ekf_update.py::workspace_floats)
extern "C" int k3_workspace_floats(int D, int NSEL) { return k3_layout(D, 2 * NSEL).n_ws; }

extern "C" int k3_joint_update(const float* x, const float* P, const float* sel, const float* z,
                               const uint8_t* succ, const int* offs, const int* attempts,
                               const int* successes, const uint8_t* sched, const uint8_t* active,
                               const int* label, const uint8_t* sel_mask, const int* top_idx,
                               float* xo, float* Po, int* att_o, int* suc_o, uint8_t* sch_o,
                               uint8_t* kill_o, float* ws, int D, int NSEL, int MF, const K3Params* p,
                               void* stream) {
  const int M = 2 * NSEL;
  if (M < 2 || M > MAX_M || MF > MAX_MF || D < 7) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)k3_layout(D, M).n_smem;
  // opt in to more than the default dynamic shared memory (static + dynamic
  // above 48 KB needs it). The attribute belongs to the current device, so
  // it is set on every launch (a cheap host call).
  cudaError_t e = cudaFuncSetAttribute(k3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K3_CLUSTER, 1, 1);
  cfg.blockDim = dim3(K3_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K3_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k3_kernel, x, P, sel, z, succ, offs, attempts, successes, sched, active, label,
                         sel_mask, top_idx, xo, Po, att_o, suc_o, sch_o, kill_o, ws, D, NSEL, MF, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
