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
// the launch. Design: ONE launch, a thread-block cluster of UC_CLUSTER CTAs
// of 512 threads, three phases:
//   1. CTA 0, the O(D M^2 + M^3) prefix: H (never formed: 10 non-zeros a
//      row, read from K1's selected columns), nu, R; P H' at the 7 + 3 NSEL
//      rows that H reads, which is all S needs; S; then L^-1 by
//      chol_linv.cuh in one warp's registers (at the M the build fixed,
//      CHOL_REG_M; the whole block at any other M), the chain of M dependent
//      steps that sets this phase's length, while the other 15 warps gather
//      the 7 + 3 NSEL columns of P that H reads and form P H' at every row;
//      then update_cluster.cuh's uc_from_linv: S^-1; W = P H' S^-1; x';
//      W S; the strips of P' = P - (W S) W' in rows and columns 3..6 and
//      from them the quaternion-norm transform's columns (cols) and rows
//      (rowsb). CTA 1, meanwhile: the bookkeeping and the kill mask. Both
//      publish what the others need (W', (W S)', cols, rowsb, the keep
//      factors, the any-match flag) to a global workspace that the wrapper
//      allocates.
//   2. cluster.sync() (release / acquire at cluster scope); every CTA copies
//      the workspace into its shared memory (uc_copy_in).
//   3. Every CTA takes every UC_CLUSTER-th 64 x 64 tile (I <= J) of the upper
//      triangle of P (uc_tiles<64, UC_SYM>: each thread 4 rows i x 2
//      columns j, lane and lane + 32; per m, 4 conflict-free words of W' and
//      (W S)' at j and two broadcast float4 at i for 16 products each way)
//      and writes both halves of P/2 + P'/2. K15 (ekf_update_dense.cu) runs
//      phases 2 and 3 and uc_from_linv as well.
// With no match at all, P passes through untransformed, as before. Labels
// are ranked as int32 (the TPU kernel ranked them as f32).
#include <cuda_runtime.h>
#include <stdint.h>

#include "update_cluster.cuh"

#define CAM_DIM 13
#define SLOT_DIM 6
#define MAX_M 64
#define MAX_MF 256
#define K3_T 64        // tile side: a thread 4 rows x 2 columns (UcTile<64>)

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
  const int tiles = 2 * K3_T * UcTile<K3_T>::TP;
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

__global__ void __launch_bounds__(UC_THREADS)
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
  float* keep = dyn + L.keep;
  const int tid = threadIdx.x, nt = blockDim.x;
  // phase 3's first tile of P, in flight from the start (P is an input)
  using Tile = UcTile<K3_T>;
  const int nT = Dp / K3_T, n_tiles = nT * (nT + 1) / 2;
  const int lane = tid & 31, r0 = Tile::RPT * (tid >> 5);  // lanes: columns; a warp: Tile::RPT rows
  float pa[Tile::RPT][Tile::CPT] = {}, pb[Tile::RPT][Tile::CPT] = {};
  if (rank < n_tiles) uc_fetch<K3_T>(P, D, nT, rank, r0, lane, pa, pb);
  UPD_MARK(0, 0);

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
    UPD_MARK(1, 0);
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
      UPD_MARK(2, 0);
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
      UPD_MARK(3, 0);
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
        UPD_MARK(4, 0);
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
        UPD_MARK(5, 32);
      }
      __syncthreads();
      UPD_MARK(6, 0);
      if (!split) {
        chol_linv_block(A, U, X, M);
        __syncthreads();
      }
      uc_from_linv(x, P, nu, S, X, Sinv, PHt, dyn, xu, ws, D, Dp, M, Mp);
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
  UPD_MARK(12, 0);
  const bool any = __ldcg(ws + L.flag) != 0.0f;
  for (int d = tid; d < Dp; d += nt) keep[d] = __ldcg(ws + L.keep + d);
  // W', (W S)', cols, rowsb: contiguous in the workspace and in shared memory
  if (rank != 0 && any) uc_copy_in(dyn4, ws, L.keep - L.Wt);
  __syncthreads();
  UPD_MARK(13, 0);
  if (rank == 0)
    for (int d = tid; d < D; d += nt) xo[d] = dyn[L.xu + d] * keep[d];

  // ================= phase 3: the upper-triangle tiles of P/2 + P'/2
  uc_tiles<K3_T, UC_SYM>(P, Po, D, Dp, M, any, dyn, keep, dyn + L.R, rank, pa, pb, nullptr);
  UPD_MARK(14, 0);
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
  cfg.gridDim = dim3(UC_CLUSTER, 1, 1);
  cfg.blockDim = dim3(UC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = UC_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, k3_kernel, x, P, sel, z, succ, offs, attempts, successes, sched, active, label,
                         sel_mask, top_idx, xo, Po, att_o, suc_o, sch_o, kill_o, ws, D, NSEL, MF, *p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
