// K5: auto-init region proposal.
//
// Replaces scenelib2_tpu/kernels/pallas_propose.py (pallas_propose_init /
// _kernel) together with the step's gate and clamp around it. The plain
// PyTorch twin is scenelib2_torch/kernels/propose.py::propose_region_plain
// (the gate, propose_plain, clamp_region): every float operation below is
// the twin's, in its order (built with -fmad=false, no fast math:
// sinf/cosf/sqrtf are the library's accurate forms, as PyTorch's own CUDA
// kernels call them).
//
// Bound on an H100: ~0.5 KB in, a few hundred scalar operations: nothing;
// the launch and the dependent scalar chains set the time. Design: one
// block of 32 + 32 ceil(MF / 32) + K5_STAGE threads, any number of tries.
//   - thread 0 runs the rollforward, the future point's projection and the
//     safe box; at the same time the next warps project their slot's point
//     (each forms R_RW with the twin's expression: it needs only q and r)
//     and the last K5_STAGE threads take a draw each.
//   - the draws by jump-ahead: draw k is x_k = (A_k x_0 + C_k) mod 2^48 in
//     64-bit integers (exact: 2^48 divides 2^64), from the table of
//     (A_k, C_k) that propose.py makes once on the host; no draw waits for
//     another. The first K5_STAGE draws and their values go to shared
//     memory; a draw past them is jumped to where it is needed.
//   - after one barrier, each warp takes every nwarps-th try: its lanes
//     test their share of the slots, __any_sync decides the try, and a free
//     try enters a shared atomicMin, so first_ok is the lowest free try.
//     A second barrier, then thread 0 writes the results and the limbs
//     after the consumed draws.
//   - the kernel also takes the step's glue around the TPU kernel: the
//     gate (speed, the visible count and the partial slots, counted by the
//     first barrier's __syncthreads_count), the region's clamp to the frame
//     and the init box the step reports (propose.py::propose_region_plain).
// Two block barriers after the safe box, whatever the number of tries.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define K5_MAX_MF 128
#define K5_STAGE 128  // draws staged in shared memory (64 tries), one a thread

struct K5Params {
  int H, W, region_w, region_h, boxsize, tries, sep, MF, keep_visible, max_init;
  float dtN, depth, fku, fkv, u0c, v0c, two_kd1, min_speed;
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

// R_RW = R(conj(q) * (1 / |q|^2)), the twin's expression
__device__ __forceinline__ void rot_rw(const float* __restrict__ xs, float R[3][3]) {
  const float q[4] = {xs[3], xs[4], xs[5], xs[6]};
  const float inv_n2 = 1.0f / (q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float qi[4] = {q[0] * inv_n2, -q[1] * inv_n2, -q[2] * inv_n2, -q[3] * inv_n2};
  rot_rows(qi, R);
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

// the state after draw k (0-based): (A_{k+1} x0 + C_{k+1}) mod 2^48
__device__ __forceinline__ uint64_t jump(const unsigned long long* __restrict__ table, int k, uint64_t x0) {
  return (table[2 * k] * x0 + table[2 * k + 1]) & ((1ULL << 48) - 1);
}

// the draw's value in f32 from its limbs, as the TPU kernel forms it
__device__ __forceinline__ float draw_value(uint64_t x) {
  const int r0 = (int)(x & 0xFFFF), r1 = (int)((x >> 16) & 0xFFFF), r2 = (int)((x >> 32) & 0xFFFF);
  return ((float)r2 * 4294967296.0f + (float)r1 * 65536.0f + (float)r0) * 3.552713678800501e-15f;
}

// draw k's state and value: staged, or jumped to
__device__ __forceinline__ uint64_t draw_state(const unsigned long long* s_x, const unsigned long long* table,
                                               int k, uint64_t x0) {
  return k < K5_STAGE ? s_x[k] : jump(table, k, x0);
}
__device__ __forceinline__ float draw_val(const float* s_val, const unsigned long long* table, int k,
                                          uint64_t x0) {
  return k < K5_STAGE ? s_val[k] : draw_value(jump(table, k, x0));
}

// region_o: ru, rv, ruf, rvf (the region clamped to the frame) and the init box
__global__ void k5_kernel(const float* __restrict__ xs, const int* __restrict__ rng,
                          const uint8_t* __restrict__ active, const uint8_t* __restrict__ full,
                          const float* __restrict__ speed, const int* __restrict__ n_visible,
                          const unsigned long long* __restrict__ table, uint8_t* __restrict__ any_ok_o,
                          int* __restrict__ rng_o, int* __restrict__ region_o, K5Params p) {
  __shared__ float safe_us, safe_vs, span_u, span_v;
  __shared__ int room, first_free;
  __shared__ float hn_u[K5_MAX_MF], hn_v[K5_MAX_MF];
  __shared__ uint8_t occupied[K5_MAX_MF];
  __shared__ unsigned long long s_x[K5_STAGE];
  __shared__ float s_val[K5_STAGE];
  const int t = threadIdx.x;
  const int n_slot = 32 * ((p.MF + 31) / 32);
  const float RW = (float)p.region_w, RH = (float)p.region_h;
  const uint64_t x0 = (uint64_t)(uint32_t)rng[0] | ((uint64_t)(uint32_t)rng[1] << 16) |
                      ((uint64_t)(uint32_t)rng[2] << 32);

  if (t == 0) {
    const int half = (p.boxsize - 1) / 2;
    const float q[4] = {xs[3], xs[4], xs[5], xs[6]};
    const float r[3] = {xs[0], xs[1], xs[2]};
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
    float R[3][3];
    rot_rw(xs, R);
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
    const float us0 = jmax(truncf(-pm_u), lo);
    const float uf0 = jmin(truncf((float)p.W - pm_u), (float)(p.W - half - 1));
    const float vs0 = jmax(truncf(-pm_v), lo);
    const float vf0 = jmin(truncf((float)p.H - pm_v), (float)(p.H - half - 1));
    safe_us = us0;
    safe_vs = vs0;
    span_u = uf0 - us0 - RW;
    span_v = vf0 - vs0 - RH;
    room = (uf0 - us0 > RW) && (vf0 - vs0 > RH);
    first_free = p.tries;
  }
  // the first K5_STAGE draws, one a thread
  const int k = t - 32 - n_slot;
  if (k >= 0 && k < 2 * p.tries) {
    const uint64_t xk = jump(table, k, x0);
    s_x[k] = xk;
    s_val[k] = draw_value(xk);
  }
  // occupancy: the current projection of slot t - 32; the partial slots
  const int slot = t - 32;
  bool partial = false;
  if (slot >= 0 && slot < p.MF) {
    const bool act_s = active[slot] != 0, full_s = full[slot] != 0;
    partial = act_s && !full_s;
    float Ri[3][3];
    rot_rw(xs, Ri);
    const float* y = xs + 13 + 6 * slot;
    float zz[3];
    for (int i = 0; i < 3; ++i) {
      const float m0 = y[0] - xs[0], m1 = y[1] - xs[1], m2 = y[2] - xs[2];
      zz[i] = (Ri[i][0] * m0 + Ri[i][1] * m1) + Ri[i][2] * m2;
    }
    float u, v;
    project(zz, p, &u, &v);
    hn_u[slot] = u;
    hn_v[slot] = v;
    occupied[slot] = act_s && full_s && zz[2] > 0.0f;
  }
  const int n_partial = __syncthreads_count(partial);

  // the tries: warp w takes tries w, w + nwarps, ...; its first free try
  // ends its walk. Lane l tests slots l, l + 32, ... (held in registers).
  const int warp = t >> 5, lane = t & 31, nwarps = blockDim.x >> 5;
  const float lo_sep = (float)p.sep, hi_u = (float)(p.region_w + p.sep), hi_v = (float)(p.region_h + p.sep);
  const float sus = safe_us, svs = safe_vs, spu = span_u, spv = span_v;
  bool mo[K5_MAX_MF / 32];
  float mu[K5_MAX_MF / 32], mv[K5_MAX_MF / 32];
#pragma unroll
  for (int r = 0; r < K5_MAX_MF / 32; ++r) {
    const int s = lane + 32 * r;
    mo[r] = s < p.MF && occupied[s];
    mu[r] = mo[r] ? hn_u[s] : 0.0f;
    mv[r] = mo[r] ? hn_v[s] : 0.0f;
  }
  for (int i = warp; i < p.tries; i += nwarps) {
    const float us = sus + truncf(spu * draw_val(s_val, table, 2 * i, x0));
    const float vs = svs + truncf(spv * draw_val(s_val, table, 2 * i + 1, x0));
    bool clash = false;
#pragma unroll
    for (int r = 0; r < K5_MAX_MF / 32; ++r)
      clash |= mo[r] && mu[r] >= us - lo_sep && mu[r] < us + hi_u && mv[r] >= vs - lo_sep && mv[r] < vs + hi_v;
    if (!__any_sync(0xffffffffu, clash)) {
      if (lane == 0) atomicMin(&first_free, i);
      break;
    }
  }
  __syncthreads();

  if (t == 0) {
    const bool want = speed[0] > p.min_speed && n_visible[0] < p.keep_visible && n_partial < p.max_init;
    const int first_ok = first_free;
    const bool any_ok_raw = first_ok < p.tries;
    const bool attempt = want && room;
    const int pick = any_ok_raw ? first_ok : 0;
    const int consumed = attempt ? (any_ok_raw ? 2 * (first_ok + 1) : 2 * p.tries) : 0;
    const int us = to_i32(safe_us + truncf(span_u * draw_val(s_val, table, 2 * pick, x0)));
    const int vs = to_i32(safe_vs + truncf(span_v * draw_val(s_val, table, 2 * pick + 1, x0)));
    any_ok_o[0] = any_ok_raw && attempt;
    // clamp_region, and the init box the step reports
    const int half = (p.boxsize - 1) / 2;
    region_o[0] = max(us, half + 1);
    region_o[1] = max(vs, half + 1);
    region_o[2] = min(us + p.region_w, p.W - half - 1);
    region_o[3] = min(vs + p.region_h, p.H - half - 1);
    region_o[4] = want ? us : 0;
    region_o[5] = want ? vs : 0;
    if (consumed == 0) {
      for (int l = 0; l < 3; ++l) rng_o[l] = rng[l];
    } else {
      const uint64_t xn = draw_state(s_x, table, consumed - 1, x0);
      rng_o[0] = (int)(xn & 0xFFFF);
      rng_o[1] = (int)((xn >> 16) & 0xFFFF);
      rng_o[2] = (int)((xn >> 32) & 0xFFFF);
    }
  }
}

// x [13 + 6 MF] f32, rng [3] i32 limbs, active, full [MF] bytes, speed []
// f32, n_visible [] i32; table [2 tries, 2] (A_k, C_k) for draws k = 1 ..
// 2 tries (propose.py::jump_table); any_ok [], rng_new [3], region [6].
extern "C" int k5_propose(const float* x, const int* rng, const uint8_t* active, const uint8_t* full,
                          const float* speed, const int* n_visible, const unsigned long long* table,
                          uint8_t* any_ok, int* rng_new, int* region, const K5Params* p, void* stream) {
  if (p->MF < 1 || p->MF > K5_MAX_MF || p->tries < 1) return (int)cudaErrorInvalidValue;
  const int threads = 32 + 32 * ((p->MF + 31) / 32) + K5_STAGE;
  k5_kernel<<<1, threads, 0, (cudaStream_t)stream>>>(x, rng, active, full, speed, n_visible, table, any_ok,
                                                      rng_new, region, *p);
  return (int)cudaGetLastError();
}
