// K2 and K8: NSSD elliptical search of the selected features.
//
// K2 replaces scenelib2_tpu/kernels/pallas_search.py
// (pallas_elliptical_search_fused / _search_kernel_fused -> _search_body ->
// _score_and_select, with pallas_score_map.py::nssd_corr_f32); K8 replaces
// the same file's pallas_elliptical_search (_search_kernel, pallas_call at
// pallas_search.py:312), the batch route with batch_pallas=False, whose
// caller gathers each feature's u8 window from its frame first. The plain
// PyTorch twins are scenelib2_torch/kernels/search.py::search_plain and
// search_windows_plain. The three sums of a cell are integers below 2^24
// (at most 121 x 255^2 = 7,868,025), exact in any order, so integer sums
// equal the twins' f32 sums after one exact conversion; only the NSSD
// formula rounds (nssd.cuh::nssd_corr, the twins' operation order, built
// with -fmad=false). Kernel and twin agree bit for bit.
//
// Bound on an H100 (search.py::bytes_and_flops): the window pixels under
// the admitted cells and those cells' sums and score formula, far below a
// microsecond for 10 features. The launch and the latency of one feature's
// chain of loads, sums and the score formula set the time. Design:
//   - only the 3-sigma box can be admitted, so a feature scores the
//     rectangle where its box meets the window and the valid centres
//     (box_range: half-widths from the twin's f32 operations, a NaN one
//     gives no cell, an infinite or huge one the whole window; every cell in
//     it is still tested exactly as the twin tests it);
//   - the rectangle's pixels are staged as u8 words in shared memory, in
//     one pass where a CTA's rows fit (above 48 KB after opting in,
//     dyn_smem.cuh), else in passes of as many
//     centre rows as fit (any search radius: the words, and so the sums,
//     are the same whatever the passes); a
//     thread takes a run of 4 adjacent centres along u, aligns the words of
//     each patch row into byte quads once (__byte_perm) and takes all three
//     sums with __dp4a (window_sums.cuh, shared with K4): the cross sum
//     with the patch row's zero-padded u8 quads, the sum with masked ones,
//     the sum of squares of the masked quads with themselves (12 quads a
//     row serve the 4 centres; no column pass and no second barrier);
//   - one pass and one reduction: an admitted cell becomes one 64-bit key,
//     the order-preserving bits of its score above the complement of
//     u * H + v (nssd.cuh::score_key), so the unsigned minimum is the
//     least score and, among its ties, the largest u * H + v (the twin
//     keeps the LAST tie in u-outer / v-inner order); warp shuffles, then
//     one shared atomicMin;
//   - where the grid is small (the single stream's 10 features) a feature
//     is a thread-block cluster of up to 8 CTAs (the wrapper picks the size
//     from K and the SMs), each taking a share of the rectangle's rows;
//     rank 0 reads the others' keys through distributed shared memory
//     after cluster.sync(). Batch grids (160-640 features) run one CTA a
//     feature.
// In the batch step the features of all lanes are one grid (K2: feature k
// searches frame k / per_lane), so one launch serves every lane. K8 takes
// the predicted centres and the u8 patches and forms the centre and the
// patch sums itself, so its wrapper launches nothing else.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include "dyn_smem.cuh"
#include "nssd.cuh"
#include "window_sums.cuh"

namespace cg = cooperative_groups;

#define K2_THREADS 256
#define K2_RUN WS_RUN          // adjacent centres a thread takes along u
#define K2_MAX_CLUSTER 8       // portable cluster size
#define K2_NO_MATCH 1e6f       // the value of a masked-out cell
#define K2_NONE 0xFFFFFFFFFFFFFFFFull  // the key of no admitted cell

struct K2Params {
  int H, W, B, side_v, side_u, per_lane, cluster;
  int pass_rows;    // centre rows a pass at most (0: a CTA's rows of the widest rectangle); fewer force passes
  int stage_words;  // set by k2_launch: words of the stage, a CTA's rows or fewer (passes)
  float no_sigma, no_sigma2, corr_thresh2, corr_sigma_thresh;
};

// The cells x of [lo0, hi0] that the box test |float(x - centre)| <= h can
// admit, as [*lo, *hi] (empty when *lo > *hi). h is a floor()ed f32
// half-width: an integer, +-inf or NaN. NaN or negative: no cell. At or above
// 2^22 (inf included): the whole range, each cell then tested exactly. Below:
// an admitted cell has |x - centre| <= h < 2^22 as an int32 difference,
// which did not wrap (x >= 0), so x lies in [centre - h, centre + h], taken in
// 64 bits because a saturated centre is INT_MIN or INT_MAX.
__device__ __forceinline__ void box_range(float h, int centre, int lo0, int hi0, int* lo, int* hi) {
  if (!(h >= 0.0f)) {
    *lo = 1;
    *hi = 0;
  } else if (h >= 4194304.0f) {
    *lo = lo0;
    *hi = hi0;
  } else {
    const long long r = __float2int_rz(h);  // exact: an integer in [0, 2^22)
    *lo = (int)max((long long)lo0, (long long)centre - r);
    *hi = (int)min((long long)hi0, (long long)centre + r);
  }
}

// a - b in int32 with two's-complement wrap, as the twins' int32 tensors
__device__ __forceinline__ int wrap_sub(int a, int b) { return (int)((unsigned)a - (unsigned)b); }

// floor(h + 0.5) converted to int32 as XLA converts (NaN -> 0, saturating):
// search.py::window_centre
__device__ __forceinline__ int centre_i32(float h) {
  const float f = floorf(h + 0.5f);
  if (isnan(f)) return 0;
  if (f >= 2147483648.0f) return INT_MAX;
  if (f <= -2147483648.0f) return INT_MIN;
  return __float2int_rz(f);
}

// Window rows r0 .. r1 + B - 2 of this CTA's rectangle, columns ca ..
// ca + nb - 1 (0 past them), staged as spw u8 words a row.
__device__ __forceinline__ void stage_rows(const uint8_t* __restrict__ win, int pitch, int ca, int nb, int spw,
                                           int r0, int r1, int B, uint32_t* stage) {
  for (int e = threadIdx.x; e < (r1 - r0 + B - 1) * spw; e += K2_THREADS) {
    const int r = e / spw, j = e - r * spw;
    const uint8_t* src = win + (size_t)(r0 + r) * pitch + ca + 4 * j;
    uint32_t w = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (4 * j + t < nb) w |= (uint32_t)src[t] << (8 * t);
    stage[e] = w;
  }
}

// The admitted cells of staged rows [0, r1 - r0), whose first cell is
// (u_first, v_first), into *key: a thread a run of K2_RUN centres along u,
// their three sums by __dp4a, the 4 scores straight-line (the patch's terms
// once), then the masks.
__device__ __forceinline__ void score_rows(const uint32_t* stage, int spw, int nrun, int nu, int r0, int r1,
                                           int u_first, int v_first, int uc, int vc, float a, float b, float c,
                                           float halfwidth, float halfheight, const uint32_t* pq,
                                           const uint32_t msk[WS_NQ], const float* psum, const K2Params& p,
                                           unsigned long long* key) {
  const float sg0 = psum[0], sg0sq = psum[1];
  const float n = (float)(p.B * p.B);
  for (int it = threadIdx.x; it < (nu > 0 ? (r1 - r0) * nrun : 0); it += K2_THREADS) {
    const int r = it / nrun, i = it - r * nrun;  // staged row, run
    uint32_t cross[K2_RUN], s1[K2_RUN], s2[K2_RUN];
    run_sums(stage + r * spw + i, spw, p.B, pq, msk, cross, s1, s2);
    const int vv = v_first + r;
    const float vrel = (float)wrap_sub(vv, vc);
#pragma unroll
    for (int s = 0; s < K2_RUN; ++s) {
      const int uu = u_first + K2_RUN * i + s;
      const float urel = (float)wrap_sub(uu, uc);
      float sd0, sd1;
      const float corr = nssd_corr(sg0, sg0sq, (float)s1[s], (float)s2[s], (float)cross[s], n, &sd0, &sd1);
      const bool box = fabsf(urel) <= halfwidth && fabsf(vrel) <= halfheight;
      const bool ellipse = a * urel * urel + 2.0f * b * urel * vrel + c * vrel * vrel < p.no_sigma2;
      if (K2_RUN * i + s < nu && box && ellipse && sd1 >= p.corr_sigma_thresh && sd0 >= p.corr_sigma_thresh)
        *key = min(*key, score_key(corr, uu * p.H + vv));  // corr is finite: sd0, sd1 >= corr_sigma_thresh
    }
  }
}

// One feature on one CTA (rank `rank` of a cluster of p.cluster): the
// rectangle's rows of this rank, staged from win (pixel (0, 0) of the
// feature's window, `pitch` bytes a row), scored and reduced to *kmin;
// PASSES: in passes of as many centre rows as p.stage_words hold (one
// where they hold them all), else in one. Rank 0's thread 0 writes the feature's outputs. pq: the patch rows
// as WS_NQ zero-padded u8 quads each; psum: the patch's sum and sum of
// squares. The caller has set *kmin to K2_NONE and filled pq and psum
// before the first barrier here.
template <bool PASSES>
__device__ __forceinline__ void search_feature(const uint8_t* __restrict__ win, int pitch, const uint32_t* pq,
                                               const float* psum, int k, int u0, int v0, int uc, int vc,
                                               float a, float b, float c, bool act, const K2Params& p,
                                               uint32_t* stage, unsigned long long* kmin, uint8_t* found,
                                               int* uo, int* vo, float* best_o, uint8_t* over_o) {
  const int B = p.B, half = (B - 1) / 2;
  const int sv = p.side_v, su = p.side_u;
  const int tid = threadIdx.x, cs = p.cluster, rank = (int)(blockIdx.x % cs);
  const float halfwidth = floorf(p.no_sigma / sqrtf(a - b * b / c));
  const float halfheight = floorf(p.no_sigma / sqrtf(c - b * b / a));
  int ulo, uhi, vlo, vhi;
  box_range(halfwidth, uc, max(u0, half), min(u0 + su - 1, p.W - 1 - half), &ulo, &uhi);
  box_range(halfheight, vc, max(v0, half), min(v0 + sv - 1, p.H - 1 - half), &vlo, &vhi);
  const int nu = max(uhi - ulo + 1, 0), nv = max(vhi - vlo + 1, 0);
  // this rank's window rows [ra, rb) of centres, and the first column ca
  const int ra = vlo - v0 + nv * rank / cs, rb = vlo - v0 + nv * (rank + 1) / cs;
  const int ca = ulo - u0;
  const int nrun = (nu + K2_RUN - 1) / K2_RUN;  // runs a row
  const int spw = nrun + 3;                     // staged words a row: a run reads 4 from its own
  const int nb = nu + B - 1;
  uint32_t msk[WS_NQ];
  quad_masks(B, msk);
  unsigned long long key = K2_NONE;
  if constexpr (PASSES) {
    // centre rows a pass: the stage holds them and the B - 1 rows below them
    // (k2_launch guarantees B rows of the widest rectangle)
    const int pass = max(p.stage_words / spw - (B - 1), 1);
    __syncthreads();  // the caller's pq, psum and *kmin
    for (int r0 = nu > 0 ? ra : rb; r0 < rb; r0 += pass) {
      const int r1 = min(rb, r0 + pass);
      if (r0 > ra) __syncthreads();  // the previous pass's words are read
      stage_rows(win, pitch, ca, nb, spw, r0, r1, B, stage);
      __syncthreads();
      score_rows(stage, spw, nrun, nu, r0, r1, u0 + ca, v0 + r0, uc, vc, a, b, c, halfwidth, halfheight, pq, msk,
                 psum, p, &key);
    }
  } else {
    if (nu > 0 && rb > ra) stage_rows(win, pitch, ca, nb, spw, ra, rb, B, stage);
    __syncthreads();  // the words, and the caller's pq, psum and *kmin
    score_rows(stage, spw, nrun, nu, ra, rb, u0 + ca, v0 + ra, uc, vc, a, b, c, halfwidth, halfheight, pq, msk, psum,
               p, &key);
  }

  // ---- one unsigned minimum: the warp, then one shared word, then the cluster
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = min(key, __shfl_xor_sync(0xffffffffu, key, o));
  if ((tid & 31) == 0 && key != K2_NONE) atomicMin(kmin, key);
  __syncthreads();
  unsigned long long m = *kmin;
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's *kmin is final
    if (rank == 0 && tid == 0)
      for (int j = 1; j < cs; ++j) m = min(m, *cluster.map_shared_rank(kmin, j));
    cluster.sync();  // no rank leaves while rank 0 reads its shared memory
  }
  if (rank == 0 && tid == 0) {
    // the twin's masked cells read 1e6: a least score above it leaves best
    // at 1e6 with no cell at the minimum
    float best = K2_NO_MATCH;
    int kb = -1;
    if (m != K2_NONE) {
      const float corr = key_score(m);
      if (corr <= K2_NO_MATCH) {
        best = corr;
        kb = key_uv(m);
      }
    }
    best_o[k] = best;
    uo[k] = kb >= 0 ? kb / p.H : -1;
    vo[k] = kb >= 0 ? kb % p.H : -1;
    found[k] = act && best <= p.corr_thresh2;
    over_o[k] = act && (halfwidth > (float)(su / 2) || halfheight > (float)(sv / 2));
  }
}

// K2: frame [n_lanes][H][W] u8, patch_rows [K][128] f32 (u8 pixels | sum | sum
// of squares), centres and origins [K] i32, sinv_abc [K][3]
template <bool PASSES>
__global__ void __launch_bounds__(K2_THREADS)
k2_kernel(const uint8_t* __restrict__ frame, const float* __restrict__ patch_rows,
          const int* __restrict__ u0s, const int* __restrict__ v0s, const int* __restrict__ ucs,
          const int* __restrict__ vcs, const float* __restrict__ sinv_abc,
          const uint8_t* __restrict__ active, uint8_t* __restrict__ found, int* __restrict__ uo,
          int* __restrict__ vo, float* __restrict__ best_o, uint8_t* __restrict__ over_o, K2Params p) {
  extern __shared__ uint32_t stage[];
  __shared__ uint32_t pq[WS_MAX_B * WS_NQ];
  __shared__ float psum[2];
  __shared__ unsigned long long kmin;
  const int k = blockIdx.x / p.cluster;
  const int B = p.B, half = (B - 1) / 2;
  const float* row = patch_rows + 128 * (size_t)k;
  patch_quads(row, B, pq, threadIdx.x, K2_THREADS);
  if (threadIdx.x == 0) {
    psum[0] = row[B * B];
    psum[1] = row[B * B + 1];
    kmin = K2_NONE;
  }
  const int u0 = u0s[k], v0 = v0s[k];
  const uint8_t* win = frame + (size_t)(k / p.per_lane) * p.H * p.W + (size_t)(v0 - half) * p.W + (u0 - half);
  search_feature<PASSES>(win, p.W, pq, psum, k, u0, v0, ucs[k], vcs[k], sinv_abc[3 * k], sinv_abc[3 * k + 1],
                 sinv_abc[3 * k + 2], active[k] != 0, p, stage, &kmin, found, uo, vo, best_o, over_o);
}

// K8: windows [K][wv][wu] u8 (gathered at (u0 - half, v0 - half)), patches
// [K][B][B] u8, h_centre [K][2] f32 (the predicted positions)
template <bool PASSES>
__global__ void __launch_bounds__(K2_THREADS)
k8_kernel(const uint8_t* __restrict__ windows, const uint8_t* __restrict__ patches,
          const int* __restrict__ u0s, const int* __restrict__ v0s, const float* __restrict__ h_centre,
          const float* __restrict__ sinv_abc, const uint8_t* __restrict__ active, uint8_t* __restrict__ found,
          int* __restrict__ uo, int* __restrict__ vo, float* __restrict__ best_o, uint8_t* __restrict__ over_o,
          K2Params p) {
  extern __shared__ uint32_t stage[];
  __shared__ uint32_t pq[WS_MAX_B * WS_NQ];
  __shared__ float psum[2];
  __shared__ unsigned long long kmin;
  const int k = blockIdx.x / p.cluster;
  const int B = p.B;
  const int wu = p.side_u + B - 1;
  // the patch as quads and its integer sums (exact), on warp 0
  if (threadIdx.x < 32) {
    const uint8_t* pt = patches + (size_t)k * B * B;
    uint32_t s = 0, q = 0;
    for (int e = threadIdx.x; e < B * WS_NQ; e += 32) {
      const int dy = e / WS_NQ, t = e - dy * WS_NQ;
      uint32_t w = 0;
      for (int j = 0; j < 4 && 4 * t + j < B; ++j) w |= (uint32_t)pt[dy * B + 4 * t + j] << (8 * j);
      pq[e] = w;
      s = __dp4a(w, 0x01010101u, s);
      q = __dp4a(w, w, q);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, o);
      q += __shfl_xor_sync(0xffffffffu, q, o);
    }
    if (threadIdx.x == 0) {
      psum[0] = (float)s;
      psum[1] = (float)q;
      kmin = K2_NONE;
    }
  }
  const uint8_t* win = windows + (size_t)k * (p.side_v + B - 1) * wu;
  search_feature<PASSES>(win, wu, pq, psum, k, u0s[k], v0s[k], centre_i32(h_centre[2 * k]),
                 centre_i32(h_centre[2 * k + 1]), sinv_abc[3 * k], sinv_abc[3 * k + 1], sinv_abc[3 * k + 2],
                 active[k] != 0, p, stage, &kmin, found, uo, vo, best_o, over_o);
}

// Checks *p, sizes the stage (p->stage_words: a CTA's rows of the widest
// rectangle, or p->pass_rows of them, at most what the device allows),
// picks the kernel (ds[0]: the one-pass form, where a
// CTA's rows fit within 48 KB; else ds[1], the pass form, which also runs
// one pass where the rows fit above 48 KB: with its 80-92 registers it ran
// those windows faster than the one-pass form's 64, PERF.md section 6), opts
// it in where the stage exceeds 48 KB (dyn_smem.cuh) and launches K x
// p->cluster CTAs, a cluster a feature when p->cluster > 1.
template <typename... Args>
static int k2_launch(DynSmem ds[2], int K, K2Params* p, void* stream, Args... args) {
  if (p->B < 1 || p->B > WS_MAX_B || p->per_lane < 1 || p->cluster < 1 || p->cluster > K2_MAX_CLUSTER ||
      p->pass_rows < 0)
    return (int)cudaErrorInvalidValue;
  int dyn_max = 0, dyn_one = 0;
  cudaError_t e = ds_max(&ds[1], &dyn_max);
  if (e == cudaSuccess) e = ds_max(&ds[0], &dyn_one);
  if (e != cudaSuccess) return (int)e;
  const int spw = (p->side_u + K2_RUN - 1) / K2_RUN + 3;  // words a row of the widest rectangle
  const int cta_rows = (p->side_v + p->cluster - 1) / p->cluster;
  const int one_pass = (cta_rows + p->B - 1) * spw;
  const int rows = p->pass_rows > 0 ? min(p->pass_rows, cta_rows) : cta_rows;
  p->stage_words = min((rows + p->B - 1) * spw, dyn_max / (int)sizeof(uint32_t));
  // a pass holds one centre row and the B - 1 rows below it
  if (p->stage_words < p->B * spw) return (int)cudaErrorInvalidValue;
  const int bytes = (int)sizeof(uint32_t) * p->stage_words;
  DynSmem* d = &ds[p->stage_words < one_pass || ds[0].stat + bytes > DS_DEFAULT ? 1 : 0];
  if (K == 0) return 0;
  e = ds_prepare(d, bytes);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)K * p->cluster, 1, 1);
  cfg.blockDim = dim3(K2_THREADS, 1, 1);
  cfg.dynamicSmemBytes = sizeof(uint32_t) * (size_t)p->stage_words;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p->cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p->cluster > 1 ? 1 : 0;
  void* argv[] = {(void*)&args..., (void*)p};
  e = cudaLaunchKernelExC(&cfg, d->fn, argv);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int k2_search(const uint8_t* frame, const float* patch_rows, const int* u0, const int* v0,
                         const int* uc, const int* vc, const float* sinv_abc, const uint8_t* active,
                         uint8_t* found, int* u, int* v, float* best, uint8_t* over, int K, const K2Params* p,
                         void* stream) {
  static DynSmem ds[2] = {{(const void*)k2_kernel<false>, {0}, {0}, 0}, {(const void*)k2_kernel<true>, {0}, {0}, 0}};
  K2Params q = *p;
  return k2_launch(ds, K, &q, stream, frame, patch_rows, u0, v0, uc, vc, sinv_abc, active, found, u, v, best,
                   over);
}

extern "C" int k8_search_windows(const uint8_t* windows, const uint8_t* patches, const int* u0, const int* v0,
                                 const float* h_centre, const float* sinv_abc, const uint8_t* active,
                                 uint8_t* found, int* u, int* v, float* best, uint8_t* over, int K,
                                 const K2Params* p, void* stream) {
  static DynSmem ds[2] = {{(const void*)k8_kernel<false>, {0}, {0}, 0}, {(const void*)k8_kernel<true>, {0}, {0}, 0}};
  K2Params q = *p;
  return k2_launch(ds, K, &q, stream, windows, patches, u0, v0, h_centre, sinv_abc, active, found, u, v, best,
                   over);
}
