// K6: Shi-Tomasi best-patch detection in the auto-init region.
//
// Replaces scenelib2_tpu/kernels/pallas_shi_tomasi.py
// (pallas_shi_tomasi_region / _st_kernel -> st_region_body). The plain
// PyTorch twin is scenelib2_torch/kernels/shi_tomasi.py::shi_tomasi_plain:
// the box sums are integers (exact in any order), and the eigenvalue runs
// the twin's f32 operations in its order (built with -fmad=false).
//
// Bound on an H100 (shi_tomasi.py::bytes_and_flops): a 72 x 92 u8 window
// and ~0.2 M operations of separable sums and eigenvalues: a fraction of a
// microsecond; the launch and the chain of passes set the time. Design:
//   - the region's rows of cells are split into bands over a cluster of
//     p.cluster CTAs (the wrapper picks the size, shi_tomasi.py::
//     cluster_size); each lane of the batch step is its own cluster;
//   - a CTA stages its band's window rows (the band plus its 12-row halo)
//     as u8 in shared memory; then, K6_CHUNK rows of cells at a time, it
//     takes the 11-row sums of gx2^2, gy2^2 and gx2 gy2 (int32, a running
//     sum down each column, every gradient column taken) into shared memory
//     rows of an odd number of words (no bank conflicts down a column) and
//     the 11-column sums of those (a running sum along each row); every sum
//     is an integer below 2^23, so the order does not change it;
//   - two kernels, picked at launch: k6_kernel_one where a CTA's band
//     window fits K6_ONE_WV x K6_ONE_WU (every configuration's region):
//     static arrays, one stage, the column sums K6_ONE_VS words a row, a
//     thread a gradient column; else k6_kernel: the window rows and column
//     sums in dynamic shared memory (above 48 KB after opting in,
//     dyn_smem.cuh), p.vstride words a row, the band in stages of
//     p.stage_rows window rows where it does not fit (any region: every sum
//     starts afresh in each pass of K6_CHUNK rows, so the stages do not
//     change it), gradient columns past the block's threads taken in turn.
//     The one-stage kernel is kept as its own code: k6_kernel's body with
//     the one-stage sizes fixed when compiled (static arrays, no stage loop)
//     ran 3-10% slower over lanes (PERF.md section 6);
//   - each admitted cell's eigenvalue becomes one 64-bit key: the high
//     word its bits when it is > 0 (positive floats order as unsigned
//     integers), else 0; the low word 0xFFFFFFFF - (v W + u), so the
//     maximum key is the largest eigenvalue and, among its ties, the
//     smallest scan key (the reference's first-in-scan-order pick); a NaN
//     eigenvalue sets a flag (the twin's maximum is then NaN: no pick);
//   - one maximum over the block, then over the cluster through
//     distributed shared memory; rank 0 writes the pick.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dyn_smem.cuh"

namespace cg = cooperative_groups;

#define K6_THREADS 512
#define K6_CHUNK 20      // rows of cells a pass of the column sums holds
#define K6_MAX_CLUSTER 8
#define K6_ONE_WV 80     // the one-stage form: window rows of a CTA's band (its rows of cells + 2 off)
#define K6_ONE_WU 100    // ... window columns (region_w + 2 off)
#define K6_ONE_VS 99     // ... words a row of its column sums (odd: no bank conflicts down a column)

struct K6Params {
  int H, W, B, region_w, region_h, cluster;
  int band_rows;   // rows of cells a stage at most (0: a CTA's whole band); fewer force stages
  // set by k6_shi_tomasi for the staged form:
  int vstride;     // words a row of the column sums: the gradient columns, made odd
  int stage_rows;  // window rows a stage holds: a CTA's band and its halo, or fewer
};

// the column sums [3][K6_CHUNK][vstride] int32, then the window rows
__host__ __device__ inline size_t k6_vsum_bytes(int vstride) {
  return sizeof(int) * 3 * (size_t)K6_CHUNK * vstride;
}

// the doubled central differences at gradient point (g, j) of the staged
// window (the window's interior point (g + 1, j + 1)), and their products
__device__ __forceinline__ void grad_products(const uint8_t* win, int wu, int g, int j, int& xx, int& yy,
                                              int& xy) {
  const int gx = (int)win[(g + 1) * wu + j + 2] - (int)win[(g + 1) * wu + j];
  const int gy = (int)win[(g + 2) * wu + j + 1] - (int)win[g * wu + j + 1];
  xx = gx * gx;
  yy = gy * gy;
  xy = gx * gy;
}

// The 11-row sums of gradient column j over the rows of cells of run `run`
// (lv rows from run * lv, within the chunk's nr) of the chunk at gradient
// row g0: a running sum down the column into vsum [3][K6_CHUNK][vs].
__device__ __forceinline__ void column_run(const uint8_t* win, int wu, int* vsum, int vs, int g0, int nr, int lv,
                                           int B, int j, int run) {
  const int rs = run * lv, re = min(nr, rs + lv);
  if (rs >= re) return;
  int sxx = 0, syy = 0, sxy = 0, a, b, c;
  for (int dy = 0; dy < B; ++dy) {
    grad_products(win, wu, g0 + rs + dy, j, a, b, c);
    sxx += a;
    syy += b;
    sxy += c;
  }
  vsum[(0 * K6_CHUNK + rs) * vs + j] = sxx;
  vsum[(1 * K6_CHUNK + rs) * vs + j] = syy;
  vsum[(2 * K6_CHUNK + rs) * vs + j] = sxy;
  for (int r = rs + 1; r < re; ++r) {
    int a2, b2, c2;
    grad_products(win, wu, g0 + r + B - 1, j, a, b, c);
    grad_products(win, wu, g0 + r - 1, j, a2, b2, c2);
    sxx += a - a2;
    syy += b - b2;
    sxy += c - c2;
    vsum[(0 * K6_CHUNK + r) * vs + j] = sxx;
    vsum[(1 * K6_CHUNK + r) * vs + j] = syy;
    vsum[(2 * K6_CHUNK + r) * vs + j] = sxy;
  }
}

// The one-stage form: a CTA's band window within K6_ONE_WV x K6_ONE_WU.
__global__ void __launch_bounds__(K6_THREADS)
k6_kernel_one(const uint8_t* __restrict__ frame, const int* __restrict__ us_p, const int* __restrict__ vs_p,
              const int* __restrict__ uf_p, const int* __restrict__ vf_p, int* __restrict__ ubest_o,
              int* __restrict__ vbest_o, float* __restrict__ ev_o, K6Params p) {
  __shared__ uint8_t win[K6_ONE_WV * K6_ONE_WU];
  __shared__ int vsum[3][K6_CHUNK][K6_ONE_VS];
  __shared__ unsigned long long red[K6_THREADS / 32];
  __shared__ unsigned long long kblock;
  __shared__ int nan_block;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cs = p.cluster, rank = (int)(blockIdx.x % cs), ln = (int)(blockIdx.x / cs);
  const int B = p.B, off = 1 + (B - 1) / 2;
  const int rw = p.region_w, rh = p.region_h;
  const int wu = rw + 2 * off, gu = wu - 2;
  const int nb = (rh + cs - 1) / cs;
  const int r0 = min(rh, rank * nb), r1 = min(rh, r0 + nb);
  frame += (size_t)ln * p.H * p.W;
  const int ustart = us_p[ln], vstart = vs_p[ln];
  const float fus = (float)ustart, fvs = (float)vstart, fuf = (float)uf_p[ln], fvf = (float)vf_p[ln];
  const int u0 = min(max(ustart, off), p.W - rw - off);
  const int v0 = min(max(vstart, off), p.H - rh - off);

  // the band's window rows: cells [r0, r1) read window rows [r0, r1 + 2 off)
  const int wrows = r1 > r0 ? r1 - r0 + 2 * off : 0;
  const uint8_t* src = frame + (size_t)(v0 - off + r0) * p.W + (u0 - off);
  for (int e = tid; e < wrows * wu; e += nt) {
    const int r = e / wu, c = e - r * wu;
    win[e] = src[r * p.W + c];
  }
  __syncthreads();

  unsigned long long key = 0ull;
  int nan = 0;
  for (int c0 = r0; c0 < r1; c0 += K6_CHUNK) {
    const int nr = min(K6_CHUNK, r1 - c0), g0 = c0 - r0;
    // 11-row sums: a thread takes one gradient column and a run of rows
    {
      const int runs = max(1, nt / gu), lv = (nr + runs - 1) / runs;
      const int j = tid % gu, run = tid / gu;
      const int rs = run * lv, re = min(nr, rs + lv);
      if (run < runs && rs < re) {
        int sxx = 0, syy = 0, sxy = 0, a, b, c;
        for (int dy = 0; dy < B; ++dy) {
          grad_products(win, wu, g0 + rs + dy, j, a, b, c);
          sxx += a;
          syy += b;
          sxy += c;
        }
        vsum[0][rs][j] = sxx;
        vsum[1][rs][j] = syy;
        vsum[2][rs][j] = sxy;
        for (int r = rs + 1; r < re; ++r) {
          int a2, b2, c2;
          grad_products(win, wu, g0 + r + B - 1, j, a, b, c);
          grad_products(win, wu, g0 + r - 1, j, a2, b2, c2);
          sxx += a - a2;
          syy += b - b2;
          sxy += c - c2;
          vsum[0][r][j] = sxx;
          vsum[1][r][j] = syy;
          vsum[2][r][j] = sxy;
        }
      }
    }
    __syncthreads();
    // 11-column sums and the cells' keys: a thread takes one row of cells
    // and a run of columns
    {
      const int runs = max(1, nt / nr), lh = (rw + runs - 1) / runs;
      const int i = tid % nr, run = tid / nr;
      const int js = run * lh, je = min(rw, js + lh);
      if (run < runs && js < je) {
        const int vv = v0 + c0 + i;
        const float vvf = (float)vv;
        const bool row_ok = vvf >= fvs && vvf < fvf && vv >= off && vv <= p.H - 1 - off;
        int sxx = 0, syy = 0, sxy = 0;
        for (int dx = 0; dx < B; ++dx) {
          sxx += vsum[0][i][js + dx];
          syy += vsum[1][i][js + dx];
          sxy += vsum[2][i][js + dx];
        }
        for (int jj = js; jj < je; ++jj) {
          if (jj > js) {
            sxx += vsum[0][i][jj + B - 1] - vsum[0][i][jj - 1];
            syy += vsum[1][i][jj + B - 1] - vsum[1][i][jj - 1];
            sxy += vsum[2][i][jj + B - 1] - vsum[2][i][jj - 1];
          }
          const int uu = u0 + jj;
          const float uuf = (float)uu;
          if (row_ok && uuf >= fus && uuf < fuf && uu >= off && uu <= p.W - 1 - off) {
            const float A = (float)sxx * 0.25f, C = (float)syy * 0.25f, Bq = (float)sxy * 0.25f;
            const float BB = sqrtf((A + C) * (A + C) - 4.0f * (A * C - Bq * Bq));
            const float ev = (A + C - BB) / 2.0f;
            if (ev != ev) nan = 1;
            else if (ev > 0.0f)
              key = max(key, ((unsigned long long)__float_as_uint(ev) << 32) |
                                 (unsigned long long)(0xFFFFFFFFu - (uint32_t)(vv * p.W + uu)));
          }
        }
      }
    }
    __syncthreads();  // before the next chunk overwrites vsum
  }

  // ---- one maximum: the warp, the block, then the cluster
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
  if ((tid & 31) == 0) red[tid >> 5] = key;
  nan = __syncthreads_or(nan);  // also the barrier for red[]
  if (tid < 32) {
    key = tid < nt / 32 ? red[tid] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (tid == 0) {
      kblock = key;
      nan_block = nan;
    }
  }
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's kblock is final
    if (rank == 0 && tid == 0)
      for (int r = 1; r < cs; ++r) {
        key = max(key, *cluster.map_shared_rank(&kblock, r));
        nan |= *cluster.map_shared_rank(&nan_block, r);
      }
    cluster.sync();  // no rank leaves while rank 0 reads its shared memory
  }
  if (rank == 0 && tid == 0) {
    const uint32_t hi = (uint32_t)(key >> 32);
    const bool found = !nan && hi > 0u;
    const int k = (int)(0xFFFFFFFFu - (uint32_t)key);
    ubest_o[ln] = found ? k % p.W : ustart;
    vbest_o[ln] = found ? k / p.W : vstart;
    ev_o[ln] = found ? __uint_as_float(hi) : 0.0f;
  }
}

// The staged form: any region.
__global__ void __launch_bounds__(K6_THREADS)
k6_kernel(const uint8_t* __restrict__ frame, const int* __restrict__ us_p, const int* __restrict__ vs_p,
          const int* __restrict__ uf_p, const int* __restrict__ vf_p, int* __restrict__ ubest_o,
          int* __restrict__ vbest_o, float* __restrict__ ev_o, K6Params p) {
  extern __shared__ __align__(16) unsigned char dyn[];
  const int vs = p.vstride;
  int* vsum = reinterpret_cast<int*>(dyn);   // [3][K6_CHUNK][vs]
  uint8_t* win = dyn + k6_vsum_bytes(vs);    // [stage_rows][wu]
  __shared__ unsigned long long red[K6_THREADS / 32];
  __shared__ unsigned long long kblock;
  __shared__ int nan_block;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int cs = p.cluster, rank = (int)(blockIdx.x % cs), ln = (int)(blockIdx.x / cs);
  const int B = p.B, off = 1 + (B - 1) / 2;
  const int rw = p.region_w, rh = p.region_h;
  const int wu = rw + 2 * off, gu = wu - 2;
  const int nb = (rh + cs - 1) / cs;
  const int r0 = min(rh, rank * nb), r1 = min(rh, r0 + nb);
  const int band = p.stage_rows - 2 * off;  // rows of cells a stage serves
  frame += (size_t)ln * p.H * p.W;
  const int ustart = us_p[ln], vstart = vs_p[ln];
  const float fus = (float)ustart, fvs = (float)vstart, fuf = (float)uf_p[ln], fvf = (float)vf_p[ln];
  const int u0 = min(max(ustart, off), p.W - rw - off);
  const int v0 = min(max(vstart, off), p.H - rh - off);

  unsigned long long key = 0ull;
  int nan = 0;
  for (int b0 = r0; b0 < r1; b0 += band) {
    const int b1 = min(r1, b0 + band);
    // the stage's window rows: cells [b0, b1) read window rows [b0, b1 + 2 off)
    // (the previous stage's last chunk ended at a barrier)
    const uint8_t* src = frame + (size_t)(v0 - off + b0) * p.W + (u0 - off);
    for (int e = tid; e < (b1 - b0 + 2 * off) * wu; e += nt) {
      const int r = e / wu, c = e - r * wu;
      win[e] = src[r * p.W + c];
    }
    __syncthreads();

    for (int c0 = b0; c0 < b1; c0 += K6_CHUNK) {
      const int nr = min(K6_CHUNK, b1 - c0), g0 = c0 - b0;
      // 11-row sums: a thread takes a gradient column and a run of rows
      // (the columns in turn where they outnumber the threads)
      {
        const int runs = max(1, nt / gu), lv = (nr + runs - 1) / runs;
        for (int e = tid; e < runs * gu; e += nt) column_run(win, wu, vsum, vs, g0, nr, lv, B, e % gu, e / gu);
      }
      __syncthreads();
      // 11-column sums and the cells' keys: a thread takes one row of cells
      // and a run of columns
      {
        const int runs = max(1, nt / nr), lh = (rw + runs - 1) / runs;
        const int i = tid % nr, run = tid / nr;
        const int js = run * lh, je = min(rw, js + lh);
        if (run < runs && js < je) {
          const int* v0r = vsum + (0 * K6_CHUNK + i) * vs;
          const int* v1r = vsum + (1 * K6_CHUNK + i) * vs;
          const int* v2r = vsum + (2 * K6_CHUNK + i) * vs;
          const int vv = v0 + c0 + i;
          const float vvf = (float)vv;
          const bool row_ok = vvf >= fvs && vvf < fvf && vv >= off && vv <= p.H - 1 - off;
          int sxx = 0, syy = 0, sxy = 0;
          for (int dx = 0; dx < B; ++dx) {
            sxx += v0r[js + dx];
            syy += v1r[js + dx];
            sxy += v2r[js + dx];
          }
          for (int jj = js; jj < je; ++jj) {
            if (jj > js) {
              sxx += v0r[jj + B - 1] - v0r[jj - 1];
              syy += v1r[jj + B - 1] - v1r[jj - 1];
              sxy += v2r[jj + B - 1] - v2r[jj - 1];
            }
            const int uu = u0 + jj;
            const float uuf = (float)uu;
            if (row_ok && uuf >= fus && uuf < fuf && uu >= off && uu <= p.W - 1 - off) {
              const float A = (float)sxx * 0.25f, C = (float)syy * 0.25f, Bq = (float)sxy * 0.25f;
              const float BB = sqrtf((A + C) * (A + C) - 4.0f * (A * C - Bq * Bq));
              const float ev = (A + C - BB) / 2.0f;
              if (ev != ev) nan = 1;
              else if (ev > 0.0f)
                key = max(key, ((unsigned long long)__float_as_uint(ev) << 32) |
                                   (unsigned long long)(0xFFFFFFFFu - (uint32_t)(vv * p.W + uu)));
            }
          }
        }
      }
      __syncthreads();  // before the next chunk overwrites vsum (or the next stage the window)
    }
  }

  // ---- one maximum: the warp, the block, then the cluster
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
  if ((tid & 31) == 0) red[tid >> 5] = key;
  nan = __syncthreads_or(nan);  // also the barrier for red[]
  if (tid < 32) {
    key = tid < nt / 32 ? red[tid] : 0ull;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) key = max(key, __shfl_xor_sync(0xffffffffu, key, o));
    if (tid == 0) {
      kblock = key;
      nan_block = nan;
    }
  }
  if (cs > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();  // every rank's kblock is final
    if (rank == 0 && tid == 0)
      for (int r = 1; r < cs; ++r) {
        key = max(key, *cluster.map_shared_rank(&kblock, r));
        nan |= *cluster.map_shared_rank(&nan_block, r);
      }
    cluster.sync();  // no rank leaves while rank 0 reads its shared memory
  }
  if (rank == 0 && tid == 0) {
    const uint32_t hi = (uint32_t)(key >> 32);
    const bool found = !nan && hi > 0u;
    const int k = (int)(0xFFFFFFFFu - (uint32_t)key);
    ubest_o[ln] = found ? k % p.W : ustart;
    vbest_o[ln] = found ? k / p.W : vstart;
    ev_o[ln] = found ? __uint_as_float(hi) : 0.0f;
  }
}

// Checks *p and launches n_lanes x p->cluster CTAs, a cluster a lane when
// p->cluster > 1: k6_kernel_one where a CTA's band window fits its
// static arrays and no stage is forced, else k6_kernel with the
// column sums' stride and the stage sized here (a CTA's band and its halo,
// at most what the device allows: stages where that is less), opted in
// where it exceeds 48 KB (dyn_smem.cuh).
extern "C" int k6_shi_tomasi(const uint8_t* frame, const int* us, const int* vs, const int* uf,
                             const int* vf, int* ubest, int* vbest, float* evbest, int n_lanes,
                             const K6Params* p, void* stream) {
  static DynSmem ds = {(const void*)k6_kernel, {0}, {0}, 0};
  const int off = 1 + (p->B - 1) / 2, wu = p->region_w + 2 * off;
  if (p->region_h < 1 || p->region_w < 1 || p->region_w > p->W - 2 * off || p->region_h > p->H - 2 * off ||
      p->cluster < 1 || p->cluster > K6_MAX_CLUSTER || p->band_rows < 0)
    return (int)cudaErrorInvalidValue;
  K6Params q = *p;
  const int nb = (q.region_h + q.cluster - 1) / q.cluster;  // rows of cells a CTA
  const int band = q.band_rows > 0 ? min(q.band_rows, nb) : nb;
  const bool staged = band < nb || nb + 2 * off > K6_ONE_WV || wu > K6_ONE_WU;
  size_t bytes = 0;
  if (staged) {
    int dyn_max = 0;
    cudaError_t e = ds_max(&ds, &dyn_max);
    if (e != cudaSuccess) return (int)e;
    q.vstride = (wu - 2) | 1;
    const long long room = ((long long)dyn_max - (long long)k6_vsum_bytes(q.vstride)) / wu;
    q.stage_rows = room < band + 2 * off ? (int)room : band + 2 * off;
    // a stage serves at least one row of cells
    if (q.stage_rows < 2 * off + 1) return (int)cudaErrorInvalidValue;
    bytes = k6_vsum_bytes(q.vstride) + (size_t)q.stage_rows * wu;
  }
  if (n_lanes == 0) return 0;
  if (staged) {
    cudaError_t e = ds_prepare(&ds, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)n_lanes * q.cluster, 1, 1);
  cfg.blockDim = dim3(K6_THREADS, 1, 1);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = q.cluster > 1 ? 1 : 0;
  cudaError_t e = staged ? cudaLaunchKernelEx(&cfg, k6_kernel, frame, us, vs, uf, vf, ubest, vbest, evbest, q)
                         : cudaLaunchKernelEx(&cfg, k6_kernel_one, frame, us, vs, uf, vf, ubest, vbest, evbest, q);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
