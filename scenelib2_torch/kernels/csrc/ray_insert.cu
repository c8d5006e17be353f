// K17: stage 7's ray insertion.
//
// Everything the step's auto-init runs after K6, in one launch: the
// init decision (any_ok and the patch score), the clamped B x B crop
// around the pick and its patch row, the ray model of
// models.part_init_ray with the camera's measurement_noise, the slot's
// new rows of P (dypi_by_dxp P[:7, :]) and its 6 x 6 block, and every
// write of state.add_partial_feature into the first free slot. The plain
// PyTorch twin is scenelib2_torch/kernels/ray_insert.py::ray_insert_plain
// (that composition, on the state without lanes): every float operation
// below is the twin's, in its order and precision (built with
// -fmad=false, no fast math: sqrtf and division correctly rounded, as
// PyTorch's own CUDA kernels compute them). Each of the twin's products
// mm_seq takes is rounded once and summed left to right, its products
// with exact zeros included (0 x inf is NaN; -0 + +0 is +0).
//
// Bound on an H100: P is copied once (D^2 floats in and out: 95 KB at
// D = 109, 4.9 MB at D = 781) and ~300 dependent scalar operations make
// the ray's Jacobians; the dependent chain, a few dependent trips to
// memory and the launch set the time at small D. Design: a grid of CTAs
// over bands of `rows` rows of P (the wrapper sizes the band to spread P
// over the SMs), 256 threads each.
//   - warp 0, lane 0 runs the scalar chain in every CTA (the same bits
//     everywhere, so the CTAs never wait for each other): dypi_by_dxp,
//     the ray ypi, and the block's dhi R dhi' term, into shared memory.
//   - meanwhile warp 1 finds the first free slot (a min over the lanes)
//     and the crop's pixel sums; after a barrier of warps 1-7 those warps
//     copy the CTA's band of rows of P but the slot's, then the grid's share
//     of the per-slot fields in one index space, four elements a thread at
//     a time with their loads before their stores (the twin's `sel`: the
//     new value at the slot where the gate is open, the old one elsewhere).
//   - after a block barrier each CTA makes the new rows and reads the
//     slot's old rows at its band's columns, makes the slot's 6 x 6 block,
//     and writes: the slot's columns in its band's rows (over its own copy),
//     the slot's rows at its band's columns (the block where those columns
//     are the slot's), and x at its band.
// The twin writes rows, then columns, then the block; each element here
// is written by one CTA with what the twin leaves there. With the gate shut
// the twin writes the slot's old rows back into its columns (P'[j, s] =
// P[s, j]), and so does this kernel. No input is written: the outputs are
// the wrapper's fresh tensors.
#include <cuda_runtime.h>
#include <stdint.h>

#define K17_MAX_MF 128
#define K17_THREADS 256
#define K17_MAX_ROWS 32   // a band's rows: the new rows at its columns, one a thread (6 x 32 <= 256 - 42)
#define K17_PATCH_ROW 128 // a slot's patch row: B x B pixels, their sum, their sum of squares, zeros
#define K17_CAM 13
#define K17_SLOT 6
#define K17_XP 7

struct K17Params {
  int H, W, B, MF, NP, D, rows;
  float thresh, u0, v0, neg_fku, neg_fkv, two_kd1, a, b, sd, prob0;
};

// the state's fields in and out, and the step's other inputs
struct K17Ptrs {
  const uint8_t* frame;
  const int* ubest;
  const int* vbest;
  const float* evbest;
  const uint8_t* any_ok;
  const float* lam0;
  const float* x;
  const float* P;
  const uint8_t* active;
  const uint8_t* full;
  const int* label;
  const uint8_t* patches;
  const float* xp_org;
  const int* attempts;
  const int* successes;
  const float* patch_rows;
  const float* lam;
  const float* prob;
  const uint8_t* palive;
  const int* match_attempts;
  const uint8_t* sched;
  const int* next_label;
  float* x_o;
  float* P_o;
  uint8_t* active_o;
  uint8_t* full_o;
  int* label_o;
  uint8_t* patches_o;
  float* xp_org_o;
  int* attempts_o;
  int* successes_o;
  float* patch_rows_o;
  float* lam_o;
  float* prob_o;
  uint8_t* palive_o;
  int* match_attempts_o;
  uint8_t* sched_o;
  int* next_label_o;
  uint8_t* did_init_o;
};

// The ray of models.part_init_ray and the block's second term
// (dhi R dhi', state.add_partial_feature), from h = (u, v) and the pose xp.
// Operation for operation the twin's tensor expressions (camera.unproject,
// the norm's seqsum, quat_to_rotation_parts, mm_seq, dRq_times_a_by_dq_parts,
// norm_jac_parts, camera.unproject_jacobian, camera.measurement_noise).
__device__ __forceinline__ void ray_chain(const K17Params& p, float hu, float hv, const float* __restrict__ xp,
                                          float (*dxp)[K17_XP], float (*T2)[K17_SLOT], float* ypi) {
  // camera.unproject
  const float c0 = hu - p.u0, c1 = hv - p.v0;
  const float radius2 = c0 * c0 + c1 * c1;
  const float distor = 1.0f - radius2 * p.two_kd1;
  const float factor = sqrtf(distor);
  const float v[3] = {c0 / factor / p.neg_fku, c1 / factor / p.neg_fkv, 1.0f};
  // hLhatRi = hLRi / |hLRi|
  const float qq = (v[0] * v[0] + v[1] * v[1]) + v[2] * v[2];
  const float norm = sqrtf(qq);
  const float a[3] = {v[0] / norm, v[1] / norm, v[2] / norm};
  // RWR = R(q)
  const float w = xp[3], x = xp[4], y = xp[5], z = xp[6];
  const float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
  const float xx = 2.0f * x * x, xy = 2.0f * x * y, xz = 2.0f * x * z;
  const float yy = 2.0f * y * y, yz = 2.0f * y * z, zz = 2.0f * z * z;
  const float R[3][3] = {{1.0f - (yy + zz), xy - wz, xz + wy},
                         {xy + wz, 1.0f - (xx + zz), yz - wx},
                         {xz - wy, yz + wx, 1.0f - (xx + yy)}};
  // ypi = [r, R hLhatRi]
  for (int i = 0; i < 3; ++i) {
    ypi[i] = xp[i];
    ypi[3 + i] = (R[i][0] * a[0] + R[i][1] * a[1]) + R[i][2] * a[2];
  }
  // dypi_by_dxp: the identity on r, dRq_times_a_by_dq(q, hLhatRi) on q
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const float dq[3][4] = {
      {2.0f * (w * a0 - z * a1 + y * a2), 2.0f * (x * a0 + y * a1 + z * a2),
       2.0f * (-y * a0 + x * a1 + w * a2), 2.0f * (-z * a0 - w * a1 + x * a2)},
      {2.0f * (z * a0 + w * a1 - x * a2), 2.0f * (y * a0 - x * a1 - w * a2),
       2.0f * (x * a0 + y * a1 + z * a2), 2.0f * (w * a0 - z * a1 + y * a2)},
      {2.0f * (-y * a0 + x * a1 + w * a2), 2.0f * (z * a0 + w * a1 - x * a2),
       2.0f * (-w * a0 + z * a1 - y * a2), 2.0f * (x * a0 + y * a1 + z * a2)}};
  for (int i = 0; i < K17_SLOT; ++i)
    for (int k = 0; k < K17_XP; ++k) dxp[i][k] = 0.0f;
  for (int i = 0; i < 3; ++i) {
    dxp[i][i] = 1.0f;
    for (int c = 0; c < 4; ++c) dxp[3 + i][3 + c] = dq[i][c];
  }
  // dvnorm_by_dv(hLRi), with the reference's qq = |v|^2
  float N[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      N[i][j] = i == j ? (1.0f - v[i] * v[i] / (qq * qq)) / qq : -(v[i] * v[j]) / (qq * qq * qq);
  // camera.unproject_jacobian: rows scaled by -1/fku and -1/fkv, row 2 zero
  const float distor3_2 = factor * distor;
  const float g = p.two_kd1 / distor3_2;
  const float inv = 1.0f / factor;
  const float UJ[3][2] = {{p.a * (c0 * c0 * g + inv), p.a * (c0 * c1 * g)},
                          {p.b * (c1 * c0 * g), p.b * (c1 * c1 * g + inv)},
                          {0.0f, 0.0f}};
  // dypi_by_dhi rows 3..5: (RWR N) UJ; rows 0..2 zero
  float dhi[K17_SLOT][2];
  for (int i = 0; i < 3; ++i) {
    dhi[i][0] = 0.0f;
    dhi[i][1] = 0.0f;
    float M[3];
    for (int j = 0; j < 3; ++j) M[j] = (R[i][0] * N[0][j] + R[i][1] * N[1][j]) + R[i][2] * N[2][j];
    for (int j = 0; j < 2; ++j) dhi[3 + i][j] = (M[0] * UJ[0][j] + M[1] * UJ[1][j]) + M[2] * UJ[2][j];
  }
  // camera.measurement_noise: eye(2) x sd^2
  const float distance = sqrtf(c0 * c0 + c1 * c1);
  const float max_distance = sqrtf(p.u0 * p.u0 + p.v0 * p.v0);
  const float sdv = (distance / max_distance + 1.0f) * p.sd;
  const float var = sdv * sdv;
  const float Rm[2][2] = {{1.0f * var, 0.0f * var}, {0.0f * var, 1.0f * var}};
  // (dhi R) dhi'
  for (int i = 0; i < K17_SLOT; ++i) {
    const float t0 = dhi[i][0] * Rm[0][0] + dhi[i][1] * Rm[1][0];
    const float t1 = dhi[i][0] * Rm[0][1] + dhi[i][1] * Rm[1][1];
    for (int j = 0; j < K17_SLOT; ++j) T2[i][j] = t0 * dhi[j][0] + t1 * dhi[j][1];
  }
}

// dxp[i] . P[0:7, c], left to right
__device__ __forceinline__ float new_row(float (*dxp)[K17_XP], int i, const float* __restrict__ P, int D,
                                         int c) {
  float acc = dxp[i][0] * P[c];
#pragma unroll
  for (int k = 1; k < K17_XP; ++k) acc = acc + dxp[i][k] * P[(size_t)k * D + c];
  return acc;
}

// The per-slot fields, in one index space: field f holds MF rows of
// field_of(f).len elements of 1 or 4 bytes.
enum { F_ACTIVE, F_FULL, F_SCHED, F_PALIVE, F_PATCHES, F_LABEL, F_ATTEMPTS, F_SUCCESSES, F_MATCH, F_XP_ORG,
       F_PATCH_ROWS, F_LAM, F_PROB, K17_FIELDS };

struct Field {
  const void* in;
  void* out;
  int len, bytes;
};

__device__ __forceinline__ Field field_of(int f, const K17Ptrs& q, const K17Params& p) {
  switch (f) {
    case F_ACTIVE: return {q.active, q.active_o, 1, 1};
    case F_FULL: return {q.full, q.full_o, 1, 1};
    case F_SCHED: return {q.sched, q.sched_o, 1, 1};
    case F_PALIVE: return {q.palive, q.palive_o, p.NP, 1};
    case F_PATCHES: return {q.patches, q.patches_o, p.B * p.B, 1};
    case F_LABEL: return {q.label, q.label_o, 1, 4};
    case F_ATTEMPTS: return {q.attempts, q.attempts_o, 1, 4};
    case F_SUCCESSES: return {q.successes, q.successes_o, 1, 4};
    case F_MATCH: return {q.match_attempts, q.match_attempts_o, 1, 4};
    case F_XP_ORG: return {q.xp_org, q.xp_org_o, K17_XP, 4};
    case F_PATCH_ROWS: return {q.patch_rows, q.patch_rows_o, K17_PATCH_ROW, 4};
    case F_LAM: return {q.lam, q.lam_o, p.NP, 4};
    default: return {q.prob, q.prob_o, p.NP, 4};
  }
}

__global__ void __launch_bounds__(K17_THREADS) k17_kernel(K17Ptrs q, K17Params p) {
  __shared__ float s_dxp[K17_SLOT][K17_XP];
  __shared__ float s_T2[K17_SLOT][K17_SLOT];
  __shared__ float s_ypi[K17_SLOT];
  __shared__ float s_nr[K17_SLOT][K17_MAX_ROWS];   // the new rows at the band's columns
  __shared__ float s_old[K17_SLOT][K17_MAX_ROWS];  // the slot's old rows there
  __shared__ float s_nr7[K17_SLOT][K17_XP];        // the new rows at columns 0..6
  __shared__ float s_blk[K17_SLOT][K17_SLOT];
  __shared__ int s_slot, s_sum, s_sumsq;
  const int t = threadIdx.x, lane = t & 31;
  const int D = p.D, MF = p.MF, B = p.B;
  const int r0 = blockIdx.x * p.rows, r1 = min(D, r0 + p.rows);
  const bool enable = q.any_ok[0] != 0 && q.evbest[0] > p.thresh;
  const int half = (B - 1) / 2;
  const int pr0 = min(max(q.vbest[0] - half, 0), p.H - B);
  const int pc0 = min(max(q.ubest[0] - half, 0), p.W - B);

  if (t == 0) {
    ray_chain(p, (float)q.ubest[0], (float)q.vbest[0], q.x, s_dxp, s_T2, s_ypi);
  } else if (t >= 32) {
    const int NT = K17_THREADS - 32;   // the copying threads: warps 1..
    if (t < 64) {
      // the first free slot (MF if none), the crop's sums (exact in int32)
      int first = MF;
      for (int m = lane; m < MF; m += 32)
        if (!q.active[m]) first = min(first, m);
      first = __reduce_min_sync(0xffffffffu, first);
      int sum = 0, sumsq = 0;
      for (int k = lane; k < B * B; k += 32) {
        const int px = q.frame[(size_t)(pr0 + k / B) * p.W + pc0 + k % B];
        sum += px;
        sumsq += px * px;
      }
      sum = __reduce_add_sync(0xffffffffu, sum);
      sumsq = __reduce_add_sync(0xffffffffu, sumsq);
      if (lane == 0) {
        s_slot = first;
        s_sum = sum;
        s_sumsq = sumsq;
      }
    }
    asm volatile("bar.sync 1, %0;" ::"r"(NT));
    const bool any_free = s_slot < MF;
    const int slot = any_free ? s_slot : 0;
    const bool doit = enable && any_free;
    const int off = K17_CAM + K17_SLOT * slot;
    // the band's rows of P but the slot's, as two runs of whole rows (the
    // slot's columns there are written again after the barrier, by this CTA)
    const int cut0 = min(max(off, r0), r1), cut1 = min(max(off + K17_SLOT, r0), r1);
    const int runs[2][2] = {{r0 * D, cut0 * D}, {cut1 * D, r1 * D}};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int lo = runs[h][0], hi = runs[h][1];
      for (int e = lo + t - 32; e < hi; e += 4 * NT) {
        float v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u * NT < hi) v[u] = q.P[e + u * NT];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          if (e + u * NT < hi) q.P_o[e + u * NT] = v[u];
      }
    }
    // the per-slot fields over the grid, the twin's `sel`: the new value at
    // the slot where the gate is open, the old one elsewhere. Four elements
    // a thread at a time, their loads before their stores.
    const int g = blockIdx.x * NT + (t - 32), stride = gridDim.x * NT;
    const int put = doit ? slot : -1;
    const int bb = B * B;
    const uint32_t label = (uint32_t)q.next_label[0];
    int total = 0;
    for (int f = 0; f < K17_FIELDS; ++f) total += MF * field_of(f, q, p).len;
    for (int e0 = g; e0 < total; e0 += 4 * stride) {
      uint32_t old[4], src[4];
      int fld[4], k[4], col[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        int e = e0 + u * stride;
        fld[u] = -1;
        if (e >= total) continue;
        int f = 0, n;
        while (e >= (n = MF * field_of(f, q, p).len)) {
          e -= n;
          ++f;
        }
        const Field F = field_of(f, q, p);
        fld[u] = f;
        k[u] = e;
        col[u] = e % F.len;
        old[u] = F.bytes == 1 ? ((const uint8_t*)F.in)[e] : ((const uint32_t*)F.in)[e];
        src[u] = 0;
        if (e / F.len == put) {
          if (f == F_PATCHES || (f == F_PATCH_ROWS && col[u] < bb))
            src[u] = q.frame[(size_t)(pr0 + col[u] / B) * p.W + pc0 + col[u] % B];
          else if (f == F_LAM)
            src[u] = __float_as_uint(q.lam0[col[u]]);
          else if (f == F_XP_ORG)
            src[u] = __float_as_uint(q.x[col[u]]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (fld[u] < 0) continue;
        const int f = fld[u], c = col[u];
        const Field F = field_of(f, q, p);
        uint32_t v = old[u];
        if (k[u] / F.len == put) {
          switch (f) {
            case F_ACTIVE: case F_PALIVE: v = 1; break;
            case F_FULL: case F_SCHED: case F_ATTEMPTS: case F_SUCCESSES: case F_MATCH: v = 0; break;
            case F_LABEL: v = label; break;
            case F_PATCH_ROWS:
              v = __float_as_uint(c < bb ? (float)src[u] : c == bb ? (float)s_sum : c == bb + 1 ? (float)s_sumsq
                                                                                              : 0.0f);
              break;
            case F_PROB: v = __float_as_uint(p.prob0); break;
            default: v = src[u];   // patches, lam, xp_org
          }
        }
        if (F.bytes == 1)
          ((uint8_t*)F.out)[k[u]] = (uint8_t)v;
        else
          ((uint32_t*)F.out)[k[u]] = v;
      }
    }
  }
  __syncthreads();

  const bool any_free = s_slot < MF;
  const int slot = any_free ? s_slot : 0;
  const bool doit = enable && any_free;
  const int off = K17_CAM + K17_SLOT * slot;
  const int nb = r1 - r0;
  // the new rows and the slot's old rows at the band's columns; the new
  // rows at columns 0..6
  if (t < K17_SLOT * nb) {
    const int i = t / nb, k = t % nb;
    s_old[i][k] = q.P[(size_t)(off + i) * D + r0 + k];
    s_nr[i][k] = new_row(s_dxp, i, q.P, D, r0 + k);
  } else if (t >= K17_THREADS - K17_SLOT * K17_XP) {
    const int u = t - (K17_THREADS - K17_SLOT * K17_XP);
    s_nr7[u / K17_XP][u % K17_XP] = new_row(s_dxp, u / K17_XP, q.P, D, u % K17_XP);
  }
  __syncthreads();
  // the block: new_rows[:, :7] dxp' + dhi R dhi'
  if (t < K17_SLOT * K17_SLOT) {
    const int i = t / K17_SLOT, j = t % K17_SLOT;
    float acc = s_nr7[i][0] * s_dxp[j][0];
#pragma unroll
    for (int k = 1; k < K17_XP; ++k) acc = acc + s_nr7[i][k] * s_dxp[j][k];
    s_blk[i][j] = acc + s_T2[i][j];
  }
  __syncthreads();
  // the slot's columns in the band's rows (odd e), its rows at the band's
  // columns (even e), the block where those columns are the slot's
  for (int e = t; e < 2 * K17_SLOT * nb; e += K17_THREADS) {
    const int i = (e >> 1) / nb, k = (e >> 1) % nb, j = r0 + k;
    const int si = off + i;
    if ((unsigned)(j - off) >= K17_SLOT) {
      const float v = doit ? s_nr[i][k] : s_old[i][k];
      if (e & 1)
        q.P_o[(size_t)j * D + si] = v;
      else
        q.P_o[(size_t)si * D + j] = v;
    } else if (!(e & 1)) {
      q.P_o[(size_t)si * D + j] = doit ? s_blk[i][j - off] : s_old[i][k];
    }
  }
  for (int c = r0 + t; c < r1; c += K17_THREADS)
    q.x_o[c] = doit && (unsigned)(c - off) < K17_SLOT ? s_ypi[c - off] : q.x[c];
  if (blockIdx.x == 0 && t == 0) {
    q.next_label_o[0] = q.next_label[0] + (doit ? 1 : 0);
    q.did_init_o[0] = enable;
  }
}

extern "C" int k17_ray_insert(const K17Ptrs* q, const K17Params* p, void* stream) {
  if (p->MF < 1 || p->MF > K17_MAX_MF || p->D != K17_CAM + K17_SLOT * p->MF || p->rows < 1 ||
      p->rows > K17_MAX_ROWS || p->B < 1 || p->B * p->B + 2 > K17_PATCH_ROW || p->NP < 1 || p->B > p->H ||
      p->B > p->W)
    return (int)cudaErrorInvalidValue;
  const int blocks = (p->D + p->rows - 1) / p->rows;
  k17_kernel<<<blocks, K17_THREADS, 0, (cudaStream_t)stream>>>(*q, *p);
  return (int)cudaGetLastError();
}
