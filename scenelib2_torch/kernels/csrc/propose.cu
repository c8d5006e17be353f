// K5: auto-init region proposal.
//
// Replaces scenelib2_tpu/kernels/pallas_propose.py (pallas_propose_init /
// _kernel). The plain PyTorch twin is scenelib2_torch/kernels/propose.py::
// propose_plain: every float operation below is the twin's, in its order
// (built with -fmad=false, no fast math: sinf/cosf/sqrtf are the library's
// accurate forms, as PyTorch's own CUDA kernels call them).
//
// Bound on an H100: ~0.5 KB in, a few hundred scalar operations: nothing;
// the launch dominates. Design: one block of 128 threads. Thread 0 runs the
// scalar chain (rollforward, future-point projection, safe box) and the
// drand48 draws in 64-bit integers (the limbs equal the reference's 16-bit
// limb arithmetic: both are the exact value mod 2^48); one thread per slot
// projects its point; each try's clash is one __syncthreads_or.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K5_THREADS 128
#define K5_MAX_TRIES 16

struct K5Params {
  int H, W, region_w, region_h, boxsize, tries, sep, MF;
  float dtN, depth, fku, fkv, u0c, v0c, two_kd1;
};

// NaN-propagating max/min (jnp.maximum / torch.maximum semantics)
__device__ __forceinline__ float jmax(float a, float b) { return (a != a || b != b) ? a + b : fmaxf(a, b); }
__device__ __forceinline__ float jmin(float a, float b) { return (a != a || b != b) ? a + b : fminf(a, b); }

__device__ __forceinline__ void rot_rows(const float q[4], float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
  const float xx = 2.0f * x * x, xy = 2.0f * x * y, xz = 2.0f * x * z;
  const float yy = 2.0f * y * y, yz = 2.0f * y * z, zz = 2.0f * z * z;
  R[0][0] = 1.0f - (yy + zz); R[0][1] = xy - wz;          R[0][2] = xz + wy;
  R[1][0] = xy + wz;          R[1][1] = 1.0f - (xx + zz); R[1][2] = yz - wx;
  R[2][0] = xz - wy;          R[2][1] = yz + wx;          R[2][2] = 1.0f - (xx + yy);
}

__device__ __forceinline__ void project(const float z[3], const K5Params& p, float* hu, float* hv) {
  const float uc0 = -p.fku * z[0] / z[2];
  const float uc1 = -p.fkv * z[1] / z[2];
  const float factor = sqrtf(1.0f + p.two_kd1 * (uc0 * uc0 + uc1 * uc1));
  *hu = uc0 / factor + p.u0c;
  *hv = uc1 / factor + p.v0c;
}

__device__ __forceinline__ int to_i32(float v) {
  if (v != v) return 0;
  return (int)fminf(fmaxf(v, -1048576.0f), 1048576.0f);
}

__global__ void __launch_bounds__(K5_THREADS)
k5_kernel(const float* __restrict__ xs, const int* __restrict__ rng, const uint8_t* __restrict__ occ,
          const uint8_t* __restrict__ want_p, int* __restrict__ us_o, int* __restrict__ vs_o,
          uint8_t* __restrict__ any_ok_o, int* __restrict__ rng_o, K5Params p) {
  __shared__ float Ri[3][3], r[3];
  __shared__ float safe_us, safe_uf, safe_vs, safe_vf;
  __shared__ float us_all[K5_MAX_TRIES], vs_all[K5_MAX_TRIES];
  __shared__ int limbs[2 * K5_MAX_TRIES][3];
  __shared__ int room;
  const int t = threadIdx.x;
  const int half = (p.boxsize - 1) / 2;
  const float RW = (float)p.region_w, RH = (float)p.region_h;

  if (t == 0) {
    const float q[4] = {xs[3], xs[4], xs[5], xs[6]};
    for (int i = 0; i < 3; ++i) r[i] = xs[i];
    // collapsed rollforward: q * q(N dt omega), r + N dt v
    const float av0 = xs[10] * p.dtN, av1 = xs[11] * p.dtN, av2 = xs[12] * p.dtN;
    const float angle = sqrtf(av0 * av0 + av1 * av1 + av2 * av2);
    const bool pos = angle > 0.0f;
    const float safe = pos ? angle : 1.0f;
    const float s = pos ? sinf(angle / 2.0f) / safe : 0.0f;
    const float c = pos ? cosf(angle / 2.0f) : 1.0f;
    const float qt[4] = {c, s * av0, s * av1, s * av2};
    const float qf[4] = {
        q[0] * qt[0] - q[1] * qt[1] - q[2] * qt[2] - q[3] * qt[3],
        q[0] * qt[1] + q[1] * qt[0] + q[2] * qt[3] - q[3] * qt[2],
        q[0] * qt[2] - q[1] * qt[3] + q[2] * qt[0] + q[3] * qt[1],
        q[0] * qt[3] + q[1] * qt[2] - q[2] * qt[1] + q[3] * qt[0],
    };
    float Rf[3][3];
    rot_rows(qf, Rf);
    float yW[3];
    for (int i = 0; i < 3; ++i) yW[i] = (xs[i] + xs[7 + i] * p.dtN) + Rf[i][2] * p.depth;
    // R_RW = R(conj(q) * (1 / |q|^2))
    const float inv_n2 = 1.0f / (q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
    const float qi[4] = {q[0] * inv_n2, -q[1] * inv_n2, -q[2] * inv_n2, -q[3] * inv_n2};
    float R[3][3];
    rot_rows(qi, R);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) Ri[i][j] = R[i][j];
    float z[3];
    for (int i = 0; i < 3; ++i) {
      const float m0 = yW[0] - r[0], m1 = yW[1] - r[1], m2 = yW[2] - r[2];
      z[i] = (R[i][0] * m0 + R[i][1] * m1) + R[i][2] * m2;
    }
    float hu, hv;
    project(z, p, &hu, &hv);
    const float pm_u = (float)p.W / 2.0f - hu;
    const float pm_v = (float)p.H / 2.0f - hv;
    const float lo = (float)(half + 1);
    safe_us = jmax(truncf(-pm_u), lo);
    safe_uf = jmin(truncf((float)p.W - pm_u), (float)(p.W - half - 1));
    safe_vs = jmax(truncf(-pm_v), lo);
    safe_vf = jmin(truncf((float)p.H - pm_v), (float)(p.H - half - 1));
    room = (safe_uf - safe_us > RW) && (safe_vf - safe_vs > RH);

    // 2 * tries drand48 draws: x <- (A x + C) mod 2^48
    const uint64_t A = 0x5DEECE66DULL, C = 0xBULL, MASK = (1ULL << 48) - 1;
    uint64_t x = (uint64_t)(uint32_t)rng[0] | ((uint64_t)(uint32_t)rng[1] << 16) |
                 ((uint64_t)(uint32_t)rng[2] << 32);
    const float span_u = safe_uf - safe_us - RW;
    const float span_v = safe_vf - safe_vs - RH;
    for (int k = 0; k < 2 * p.tries; ++k) {
      x = (A * x + C) & MASK;
      const int r0 = (int)(x & 0xFFFF), r1 = (int)((x >> 16) & 0xFFFF), r2 = (int)((x >> 32) & 0xFFFF);
      limbs[k][0] = r0;
      limbs[k][1] = r1;
      limbs[k][2] = r2;
      const float val = ((float)r2 * 4294967296.0f + (float)r1 * 65536.0f + (float)r0) * 3.552713678800501e-15f;
      if (k % 2 == 0) us_all[k / 2] = safe_us + truncf(span_u * val);
      else vs_all[k / 2] = safe_vs + truncf(span_v * val);
    }
  }
  __syncthreads();

  // occupancy: this slot's current projection
  bool occupied = false;
  float hn_u = 0.0f, hn_v = 0.0f;
  if (t < p.MF) {
    const float* y = xs + 13 + 6 * t;
    float zz[3];
    for (int i = 0; i < 3; ++i) {
      const float m0 = y[0] - r[0], m1 = y[1] - r[1], m2 = y[2] - r[2];
      zz[i] = (Ri[i][0] * m0 + Ri[i][1] * m1) + Ri[i][2] * m2;
    }
    project(zz, p, &hn_u, &hn_v);
    occupied = occ[t] != 0 && zz[2] > 0.0f;
  }
  int first_ok = -1;
  for (int i = 0; i < p.tries; ++i) {
    const float us = us_all[i], vs = vs_all[i];
    const bool clash_here = occupied && hn_u >= us - (float)p.sep &&
                            hn_u < us + (float)(p.region_w + p.sep) && hn_v >= vs - (float)p.sep &&
                            hn_v < vs + (float)(p.region_h + p.sep);
    const int clash = __syncthreads_or(clash_here);
    if (!clash && first_ok < 0) first_ok = i;
  }

  if (t == 0) {
    const bool any_ok_raw = first_ok >= 0;
    const bool attempt = (want_p[0] != 0) && room;
    const int pick = any_ok_raw ? first_ok : 0;
    const int consumed = attempt ? (any_ok_raw ? 2 * (first_ok + 1) : 2 * p.tries) : 0;
    us_o[0] = to_i32(us_all[pick]);
    vs_o[0] = to_i32(vs_all[pick]);
    any_ok_o[0] = any_ok_raw && attempt;
    for (int l = 0; l < 3; ++l) rng_o[l] = consumed == 0 ? rng[l] : limbs[consumed - 1][l];
  }
}

extern "C" int k5_propose(const float* x, const int* rng, const uint8_t* occ, const uint8_t* want,
                          int* us, int* vs, uint8_t* any_ok, int* rng_new, const K5Params* p,
                          void* stream) {
  if (p->MF > K5_THREADS || p->tries > K5_MAX_TRIES || p->tries < 1) return (int)cudaErrorInvalidValue;
  k5_kernel<<<1, K5_THREADS, 0, (cudaStream_t)stream>>>(x, rng, occ, want, us, vs, any_ok, rng_new, *p);
  return (int)cudaGetLastError();
}
