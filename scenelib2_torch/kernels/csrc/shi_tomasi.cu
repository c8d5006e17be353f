// K6: Shi-Tomasi best-patch detection in the auto-init region.
//
// Replaces scenelib2_tpu/kernels/pallas_shi_tomasi.py
// (pallas_shi_tomasi_region / _st_kernel -> st_region_body). The plain
// PyTorch twin is scenelib2_torch/kernels/shi_tomasi.py::shi_tomasi_plain:
// the box sums are integers (exact in any order), and the eigenvalue runs
// the twin's f32 operations in its order (built with -fmad=false).
//
// Bound on an H100: a 72 x 92 u8 window and ~2 MOP: far below a
// microsecond; the launch dominates. Design: one block of 512 threads per
// lane (the batch step's lanes are the grid: one launch for all); the
// window (u8) and the doubled gradients (int16) in shared memory; a thread
// per output cell sums its 121 gradient products in int32 and takes the
// eigenvalue; block reductions give the maximum (NaN if any masked value is
// NaN, as jnp.max) and then the smallest v*W + u key among the cells at the
// maximum (the reference's first-in-scan-order pick).
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K6_THREADS 512
#define K6_MAX_WV 80   // region_h + 2 * off
#define K6_MAX_WU 100  // region_w + 2 * off

struct K6Params {
  int H, W, B, region_w, region_h;
};

__device__ __forceinline__ float block_max_f(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

__device__ __forceinline__ int block_min_i(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < (int)(blockDim.x >> 5) ? red[lane] : 0x7fffffff;
    for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
    if (lane == 0) red[0] = v;
  }
  __syncthreads();
  v = red[0];
  __syncthreads();
  return v;
}

// the smaller eigenvalue of cell (i, j) and whether the mask admits it
__device__ __forceinline__ bool cell_ev(const int16_t* gx, const int16_t* gy, int gu, int i, int j,
                                        int u0, int v0, float fus, float fvs, float fuf, float fvf,
                                        int off, const K6Params& p, float* ev_out) {
  const int uu = u0 + j, vv = v0 + i;
  const float uuf = (float)uu, vvf = (float)vv;
  const bool mask = uuf >= fus && uuf < fuf && vvf >= fvs && vvf < fvf && uu >= off &&
                    uu <= p.W - 1 - off && vv >= off && vv <= p.H - 1 - off;
  if (!mask) return false;
  int sxx = 0, syy = 0, sxy = 0;
  for (int dy = 0; dy < p.B; ++dy) {
    const int16_t* rx = gx + (i + dy) * gu + j;
    const int16_t* ry = gy + (i + dy) * gu + j;
    for (int dx = 0; dx < p.B; ++dx) {
      const int a = rx[dx], b = ry[dx];
      sxx += a * a;
      syy += b * b;
      sxy += a * b;
    }
  }
  const float A = (float)sxx * 0.25f, C = (float)syy * 0.25f, Bq = (float)sxy * 0.25f;
  const float BB = sqrtf((A + C) * (A + C) - 4.0f * (A * C - Bq * Bq));
  *ev_out = (A + C - BB) / 2.0f;
  return true;
}

__global__ void __launch_bounds__(K6_THREADS)
k6_kernel(const uint8_t* __restrict__ frame, const int* __restrict__ us_p, const int* __restrict__ vs_p,
          const int* __restrict__ uf_p, const int* __restrict__ vf_p, int* __restrict__ ubest_o,
          int* __restrict__ vbest_o, float* __restrict__ ev_o, K6Params p) {
  __shared__ uint8_t win[K6_MAX_WV * K6_MAX_WU];
  __shared__ int16_t gx[(K6_MAX_WV - 2) * (K6_MAX_WU - 2)];
  __shared__ int16_t gy[(K6_MAX_WV - 2) * (K6_MAX_WU - 2)];
  __shared__ float redf[32];
  __shared__ int redi[32];
  const int off = 1 + (p.B - 1) / 2;
  const int rw = p.region_w, rh = p.region_h;
  const int wv = rh + 2 * off, wu = rw + 2 * off, gu = wu - 2;
  const int ln = blockIdx.x;
  frame += (size_t)ln * p.H * p.W;
  const int ustart = us_p[ln], vstart = vs_p[ln];
  const float fus = (float)ustart, fvs = (float)vstart, fuf = (float)uf_p[ln], fvf = (float)vf_p[ln];
  const int u0 = min(max(ustart, off), p.W - rw - off);
  const int v0 = min(max(vstart, off), p.H - rh - off);

  for (int e = threadIdx.x; e < wv * wu; e += blockDim.x) {
    const int r = e / wu, c = e - r * wu;
    win[e] = frame[(v0 - off + r) * p.W + (u0 - off + c)];
  }
  __syncthreads();
  for (int e = threadIdx.x; e < (wv - 2) * gu; e += blockDim.x) {
    const int i = e / gu, j = e - i * gu;
    gx[e] = (int16_t)((int)win[(i + 1) * wu + j + 2] - (int)win[(i + 1) * wu + j]);
    gy[e] = (int16_t)((int)win[(i + 2) * wu + j + 1] - (int)win[i * wu + j + 1]);
  }
  __syncthreads();

  float vmax = -INFINITY;
  int has_nan = 0;
  for (int e = threadIdx.x; e < rh * rw; e += blockDim.x) {
    const int i = e / rw, j = e - i * rw;
    float ev;
    if (cell_ev(gx, gy, gu, i, j, u0, v0, fus, fvs, fuf, fvf, off, p, &ev)) {
      if (ev != ev) has_nan = 1;
      else vmax = fmaxf(vmax, ev);
    }
  }
  float best = block_max_f(vmax, redf);
  const bool nan_best = __syncthreads_or(has_nan) != 0;
  if (nan_best) best = NAN;

  int kmin = 0x7fffffff;
  if (!nan_best) {
    for (int e = threadIdx.x; e < rh * rw; e += blockDim.x) {
      const int i = e / rw, j = e - i * rw;
      float ev;
      if (cell_ev(gx, gy, gu, i, j, u0, v0, fus, fvs, fuf, fvf, off, p, &ev) && ev == best)
        kmin = min(kmin, (v0 + i) * p.W + (u0 + j));
    }
  }
  kmin = block_min_i(kmin, redi);

  if (threadIdx.x == 0) {
    const bool found = best > 0.0f;
    ubest_o[ln] = found ? kmin % p.W : ustart;
    vbest_o[ln] = found ? kmin / p.W : vstart;
    ev_o[ln] = found ? best : 0.0f;
  }
}

extern "C" int k6_shi_tomasi(const uint8_t* frame, const int* us, const int* vs, const int* uf,
                             const int* vf, int* ubest, int* vbest, float* evbest, int n_lanes,
                             const K6Params* p, void* stream) {
  const int off = 1 + (p->B - 1) / 2;
  if (p->region_h + 2 * off > K6_MAX_WV || p->region_w + 2 * off > K6_MAX_WU) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return 0;
  k6_kernel<<<n_lanes, K6_THREADS, 0, (cudaStream_t)stream>>>(frame, us, vs, uf, vf, ubest, vbest, evbest, *p);
  return (int)cudaGetLastError();
}
