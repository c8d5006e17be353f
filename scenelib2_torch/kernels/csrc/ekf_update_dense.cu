// K15: fused joint EKF update + quaternion-norm transform + select + delete +
//      symmetrize, with H, nu and R given dense.
//
// Replaces scenelib2_tpu/kernels/pallas_ekf.py (pallas_joint_update_norm /
// _update_kernel, pallas_call at pallas_ekf.py:150, kernel :39-114): S = H P
// H' + R; L^-1, S^-1, W = P H' S^-1, x' = x + W nu, P' = P - (W S) W' and
// the quaternion-norm transform of P'; the prior where any_succ is false;
// the keep mask as a multiply (P * keep keep', x * keep: a NaN in a deleted
// row stays NaN, as in the TPU kernel); P/2 + P'/2, P' formed as the TPU
// kernel forms it, the product P I: [k][j] is NaN where column k of the
// masked P holds a non-finite entry in a row other than j. The plain
// PyTorch twin is
// scenelib2_torch/kernels/ekf_update.py::joint_update_dense_plain; every sum
// runs left to right in the same order (built with -fmad=false).
//
// Bound on an H100 at D = 109, M = 20: ~0.1 MB in and out and ~2 MFLOP (the
// dense P H' and H (P H') sum over all D state dimensions), a microsecond at
// most; the M dependent factorisation steps, the cluster's barriers and the
// launch set the time. Design: K3's (ekf_update.cu), one launch of a cluster
// of UC_CLUSTER CTAs, sharing K3's phases (update_cluster.cuh):
//   1. Every CTA stages its Dp / UC_CLUSTER rows of P at an odd pitch (Dp +
//      1: lanes along d read conflict-free) and H transposed ([k][Mp]),
//      forms P H' at those rows over every column of P, left to right (a
//      thread 4 m x 1 d, H' read as a broadcast float4: each CTA an eighth
//      of the D^2 M multiply-adds, which bound CTA 0 alone by its issue rate),
//      and stores them into CTA 0's shared memory (distributed shared
//      memory; a split cluster barrier, arrived at the start and waited on
//      before the first store, makes sure every CTA has started), in both
//      layouts, [m][d] and [d][m]; a cluster.sync() publishes them. Then
//      CTA 0: S = H (P H') + R (a thread 4 n x 1 m, lanes along m); X = L^-1
//      in warp 0's registers at the M the build fixed (CHOL_REG_M), else by
//      the block; then uc_from_linv (S^-1, W, x', W S, the strips), which
//      publishes W', (W S)', cols and rowsb. CTA 1 zeroes the workspace's
//      column counts. The stage lies over the published arrays (dead until
//      W is formed).
//   2. cluster.sync(); the other CTAs copy the published arrays in.
//   3. Every CTA forms its K15_T x K15_T tiles of the upper triangle
//      (uc_tiles<K15_T, UC_COUNT>): at D <= 128, 32 x 32 tiles give up to 10
//      tiles for the 8 CTAs (64 x 64 tiles would give 3). It writes P/2 +
//      P'/2 with P' the transpose, which is the result wherever the masked
//      P is finite, and counts each column's non-finite entries in shared
//      memory; the counts are added into the workspace, another
//      cluster.sync() publishes them, and only where some column holds a
//      non-finite entry does every CTA form its tiles again with the
//      transposition rule (uc_tiles<K15_T, UC_RULE>).
// Two forms, picked at launch from the shared memory the device allows
// (k15_joint_update_dense): FORM 0 keeps S, S^-1 and the factorisation's A,
// U, X in shared memory; FORM 1 (large M: at D = M = 128 the five M x M
// arrays alone take 320 KB) keeps them in the workspace.
#include <cuda_runtime.h>
#include <stdint.h>

#include "dyn_smem.cuh"
#include "update_cluster.cuh"

#define K15_T 32      // tile side
#define K15_MAX 128   // D and M at most (pallas_ekf.py:136: one 128-lane row)
#define K15_LOADS 8   // float4 loads in flight a thread while P and H are staged

// offsets (floats) of the shared memory (the published arrays at uc_pub's
// offsets first, every array 16-byte aligned) and of the workspace
struct K15Layout {
  int Dp, Mp, RPC;       // D rounded up to the tile, M up to 4; rows of P H' a CTA, Dp / UC_CLUSTER
  int Ps, Ht, PHn;       // stage until W: a CTA's rows of P [RPC][Dp + 1], H' [D][Mp], (CTA 0) P H' [Dp][Mp]
  int keep, xu, nu, R;   // keep [Dp]; x' [Dp]; nu [Mp]; (P H')' [M][Dp] or the two staged tiles
  int S, Sinv, A, U, X;  // [M][Mp], [M][Mp], [M][M] x 3: shared memory (form 0) or the workspace (form 1)
  int cnt;               // workspace: each column's non-finite entries [Dp] (int32)
  int n_smem, n_ws;
};

__host__ __device__ inline K15Layout k15_layout(int D, int M, int form) {
  K15Layout L;
  L.Dp = (D + K15_T - 1) / K15_T * K15_T;
  L.Mp = (M + 3) / 4 * 4;
  L.RPC = L.Dp / UC_CLUSTER;
  const int pub = uc_pub(L.Dp, M).end;
  L.Ps = 0;
  L.Ht = (L.RPC * (L.Dp + 1) + 3) / 4 * 4;
  L.PHn = L.Ht + D * L.Mp;
  const int stage = L.PHn + L.Dp * L.Mp;
  int o = pub > stage ? pub : stage;
  L.keep = o; o += L.Dp;
  L.xu = o; o += L.Dp;
  L.nu = o; o += L.Mp;
  L.R = o;
  const int tiles = 2 * K15_T * UcTile<K15_T>::TP;
  o += M * L.Dp > tiles ? M * L.Dp : tiles;
  int w = pub;
  L.cnt = w; w += L.Dp;
  int& mm = form == 0 ? o : w;
  L.S = mm; mm += M * L.Mp;
  L.Sinv = mm; mm += M * L.Mp;
  L.A = mm; mm += M * M;
  L.U = mm; mm += M * M;
  L.X = mm; mm += M * M;
  L.n_smem = o;
  L.n_ws = w;
  return L;
}

// x [D], P [D][D], H [M][D], nu [M], R [M][M], any_succ [1], keep_in [D]
// -> xo [D], Po [D][D]
template <int FORM>
__global__ void __launch_bounds__(UC_THREADS)
k15_kernel(const float* __restrict__ x, const float* __restrict__ P, const float* __restrict__ H,
           const float* __restrict__ nu, const float* __restrict__ R, const uint8_t* __restrict__ any_succ,
           const uint8_t* __restrict__ keep_in, float* __restrict__ xo, float* __restrict__ Po, float* ws, int D,
           int M) {
  extern __shared__ float4 dyn4[];
  float* dyn = reinterpret_cast<float*>(dyn4);
  __shared__ int cnt[K15_MAX];  // the non-finite entries of each column of the masked P
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const K15Layout L = k15_layout(D, M, FORM);
  const int Dp = L.Dp, Mp = L.Mp;
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool any = any_succ[0] != 0;
  float* keep = dyn + L.keep;
  int* cnt_ws = reinterpret_cast<int*>(ws + L.cnt);
  // phase 3's first tile of P, in flight from the start (P is an input)
  using Tile = UcTile<K15_T>;
  const int nT = Dp / K15_T, n_tiles = nT * (nT + 1) / 2;
  const int lane = tid & 31, r0 = Tile::RPT * (tid >> 5);
  float pa[Tile::RPT][Tile::CPT] = {}, pb[Tile::RPT][Tile::CPT] = {};
  if (rank < n_tiles) uc_fetch<K15_T>(P, D, nT, rank, r0, lane, pa, pb);
  for (int d = tid; d < Dp; d += nt) {
    keep[d] = d < D && keep_in[d] != 0 ? 1.0f : 0.0f;
    cnt[d] = 0;
  }
  UPD_MARK(0, 0);

  if (any) {
    // ================= phase 1a, every CTA: its rows [d0, d0 + RPC) of P H'
    // (the cluster barrier's arrival now, its wait before the first store to
    // CTA 0's shared memory: every CTA has started by then)
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    float* Ps = dyn + L.Ps;
    float* Ht = dyn + L.Ht;
    const int RPC = L.RPC, d0 = rank * RPC;
    // ---- the stage: the CTA's rows of P at pitch Dp + 1 and H' [k][m] (its
    // pad columns zero), K15_LOADS loads in flight a thread (one round at
    // D = 109, M = 20)
    const int nP = max(min(d0 + RPC, D) - d0, 0) * D, nPH = nP + M * D;
    const float* Pr = P + (size_t)d0 * D;
    for (int e0 = tid; e0 < nPH; e0 += K15_LOADS * nt) {
      float v[K15_LOADS];
#pragma unroll
      for (int j = 0; j < K15_LOADS; ++j) {
        const int e = min(e0 + j * nt, nPH - 1);
        v[j] = __ldg(e < nP ? Pr + e : H + (e - nP));
      }
#pragma unroll
      for (int j = 0; j < K15_LOADS; ++j) {
        const int e = e0 + j * nt;
        if (e < nP) {
          const int r = e / D;
          Ps[r * (Dp + 1) + (e - r * D)] = v[j];
        } else if (e < nPH) {
          const int f = e - nP, m = f / D;
          Ht[(f - m * D) * Mp + m] = v[j];
        }
      }
    }
    for (int e = tid; e < D * (Mp - M); e += nt) {
      const int k = e / (Mp - M);
      Ht[k * Mp + M + (e - k * (Mp - M))] = 0.0f;
    }
    __syncthreads();
    UPD_MARK(1, 0);
    // ---- P H' at the CTA's rows over every state dimension, ascending: a
    // thread four columns m of a row d ((Mp / 4) RPC <= 512 tasks: one a
    // thread; lanes along d read the odd pitch free of bank conflicts, H'
    // one broadcast float4 a step), k unrolled by four
    const int n0 = 4 * (tid / RPC), r = tid - (tid / RPC) * RPC, d = d0 + r;
    const bool mine = n0 < Mp && d < D;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (mine) {
      const float* pr = Ps + r * (Dp + 1);
      const float* hk = Ht + n0;
      {
        const float4 h4 = *reinterpret_cast<const float4*>(hk);
        const float h[4] = {h4.x, h4.y, h4.z, h4.w};
        const float x0 = pr[0];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = x0 * h[q];
      }
#pragma unroll 4
      for (int k = 1; k < D; ++k) {
        const float4 h4 = *reinterpret_cast<const float4*>(hk + k * Mp);
        const float h[4] = {h4.x, h4.y, h4.z, h4.w};
        const float x0 = pr[k];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = acc[q] + x0 * h[q];
      }
    }
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    // into CTA 0's shared memory: (P H')' [M][Dp] and P H' [Dp][Mp] (its pad
    // columns zero)
    if (mine) {
      float* PHt0 = cluster.map_shared_rank(dyn + L.R, 0);
      float* PHn0 = cluster.map_shared_rank(dyn + L.PHn, 0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (n0 + q < M) PHt0[(n0 + q) * Dp + d] = acc[q];
        PHn0[d * Mp + n0 + q] = n0 + q < M ? acc[q] : 0.0f;
      }
    }
    cluster.sync();
    UPD_MARK(2, 0);
  }

  if (rank == 0) {
    // ================= phase 1b, CTA 0: the update's prefix from P H'
    float* xu = dyn + L.xu;
    if (any) {
      const float* Ht = dyn + L.Ht;
      const float* PHn = dyn + L.PHn;
      float* nus = dyn + L.nu;
      float* PHt = dyn + L.R;  // (P H')' [M][Dp]
      float* mm = FORM == 0 ? dyn : ws;
      float* S = mm + L.S;
      float* Sinv = mm + L.Sinv;
      float* A = mm + L.A;
      float* U = mm + L.U;
      float* X = mm + L.X;
      for (int m = tid; m < M; m += nt) nus[m] = nu[m];
      // ---- S = H (P H') + R: a thread four columns n of a row m (lanes
      // along m: H' conflict-free, P H' one broadcast float4 a step), k
      // unrolled by four; S's pad columns, n in [M, Mp), zero
      for (int e = tid; e < M * (Mp / 4); e += nt) {
        const int n0 = 4 * (e / M), m = e - (e / M) * M;
        const float* hm = Ht + m;
        const float* pk = PHn + n0;
        float rq[4], acc[4];  // R's entries, loaded while the sums run
#pragma unroll
        for (int q = 0; q < 4; ++q) rq[q] = n0 + q < M ? __ldg(R + m * M + n0 + q) : 0.0f;
        {
          const float4 p4 = *reinterpret_cast<const float4*>(pk);
          const float ph[4] = {p4.x, p4.y, p4.z, p4.w};
          const float h = hm[0];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = h * ph[q];
        }
#pragma unroll 4
        for (int k = 1; k < D; ++k) {
          const float4 p4 = *reinterpret_cast<const float4*>(pk + k * Mp);
          const float ph[4] = {p4.x, p4.y, p4.z, p4.w};
          const float h = hm[k * Mp];
#pragma unroll
          for (int q = 0; q < 4; ++q) acc[q] = acc[q] + h * ph[q];
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int n = n0 + q;
          if (n >= M) {
            S[m * Mp + n] = 0.0f;
            continue;
          }
          const float sv = acc[q] + rq[q];
          S[m * Mp + n] = sv;
          A[m * M + n] = sv;
          U[m * M + n] = 0.0f;
        }
      }
      __syncthreads();
      UPD_MARK(3, 0);
      // ---- X = L^-1 (chol_linv.cuh): warp 0's registers where the build
      // fixed this M, else the block
      if (chol_linv_reg_sized(M)) {
        if (tid < 32) chol_linv_reg_any(A, X, M);
      } else {
        chol_linv_block(A, U, X, M);
      }
      UPD_MARK(4, 0);
      __syncthreads();
      UPD_MARK(6, 0);
      uc_from_linv(x, P, nus, S, X, Sinv, PHt, dyn, xu, ws, D, Dp, M, Mp);
    } else {
      // no match at all: the prior passes through
      for (int d = tid; d < D; d += nt) xu[d] = x[d];
    }
    __threadfence();
  } else if (rank == 1) {
    for (int d = tid; d < Dp; d += nt) cnt_ws[d] = 0;
    __threadfence();
  }

  // ================= phase 2: publish (cluster barrier), then copy in
  cluster.sync();
  UPD_MARK(12, 0);
  if (rank != 0 && any) uc_copy_in(dyn4, ws, uc_pub(Dp, M).end);
  __syncthreads();
  UPD_MARK(13, 0);
  if (rank == 0)
    for (int d = tid; d < D; d += nt) xo[d] = dyn[L.xu + d] * keep[d];

  // ================= phase 3: the tiles, P' as the transpose, counting
  uc_tiles<K15_T, UC_COUNT>(P, Po, D, Dp, M, any, dyn, keep, dyn + L.R, rank, pa, pb, cnt);
  __syncthreads();
  for (int d = tid; d < Dp; d += nt)
    if (cnt[d] != 0) atomicAdd(cnt_ws + d, cnt[d]);
  UPD_MARK(14, 0);
  cluster.sync();
  // the whole matrix's counts; the tiles again with the rule where any is
  // non-zero (a rare input: the first pass's result stands otherwise)
  int bad = 0;
  for (int d = tid; d < Dp; d += nt) {
    const int c = __ldcg(cnt_ws + d);
    cnt[d] = c;
    bad |= c;
  }
  if (__syncthreads_or(bad) && rank < n_tiles) {
    uc_fetch<K15_T>(P, D, nT, rank, r0, lane, pa, pb);
    uc_tiles<K15_T, UC_RULE>(P, Po, D, Dp, M, any, dyn, keep, dyn + L.R, rank, pa, pb, cnt);
  }
  UPD_MARK(15, 0);
}

// floats of the workspace a call needs (ekf_update.py::dense_workspace_floats):
// the larger form's
extern "C" int k15_workspace_floats(int D, int M) { return k15_layout(D, M, 1).n_ws; }

static DynSmem k15_ds[2] = {{(const void*)k15_kernel<0>, {0}, {0}, 0}, {(const void*)k15_kernel<1>, {0}, {0}, 0}};

// *form: the form a launch at (D, M) takes on the current device (0: the
// M x M arrays in shared memory, 1: in the workspace; -1: neither fits) and
// *bytes its dynamic shared memory
static cudaError_t k15_form(int D, int M, int* form, int* bytes) {
  *form = -1;
  for (int f = 0; f < 2; ++f) {
    int dyn_max = 0;
    const cudaError_t e = ds_max(&k15_ds[f], &dyn_max);
    if (e != cudaSuccess) return e;
    *bytes = (int)sizeof(float) * k15_layout(D, M, f).n_smem;
    if (*bytes <= dyn_max) {
      *form = f;
      break;
    }
  }
  return cudaSuccess;
}

// x [D], P [D][D], H [M][D], nu [M], R [M][M], any_succ [1], keep [D] ->
// xo [D], Po [D][D]; ws: k15_workspace_floats(D, M) floats
extern "C" int k15_joint_update_dense(const float* x, const float* P, const float* H, const float* nu,
                                      const float* R, const uint8_t* any_succ, const uint8_t* keep,
                                      float* xo, float* Po, float* ws, int D, int M, void* stream) {
  if (D < 7 || D > K15_MAX || M < 1 || M > K15_MAX) return (int)cudaErrorInvalidValue;
  int form = -1, bytes = 0;
  cudaError_t e = k15_form(D, M, &form, &bytes);
  if (e != cudaSuccess) return (int)e;
  if (form < 0) return (int)cudaErrorInvalidValue;
  e = ds_prepare(&k15_ds[form], bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(UC_CLUSTER, 1, 1);
  cfg.blockDim = dim3(UC_THREADS, 1, 1);
  cfg.dynamicSmemBytes = (size_t)bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = UC_CLUSTER;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, form == 0 ? k15_kernel<0> : k15_kernel<1>, x, P, H, nu, R, any_succ, keep, xo, Po,
                         ws, D, M);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
