// K1: fused EKF predict + per-slot measurement prediction + top-NSEL select.
//
// Replaces scenelib2_tpu/kernels/pallas_predict_measure.py
// (pallas_predict_measure / _predict_measure_kernel). The plain PyTorch twin
// is scenelib2_torch/kernels/predict_measure.py::predict_measure_plain; this
// kernel performs the same float operations in the same order.
//
// Bound on an H100 (predict_measure.py::bytes_and_flops): P read once and P'
// written once, 2 x 4 D^2 bytes (1.1 MB at D = 373, 0.33 us at 3.35 TB/s);
// the operations are far fewer. Design: a grid of 1 + n_copy CTAs.
//   - CTA 0 runs the critical path: the motion model's F and Q (threads
//     split the entries), the 13 x 13 camera block of F P and the columns
//     each slot's chain reads, A and Pc (written to P'), x', one thread per
//     slot for the measurement chain (measure_chain.cuh), the rank by
//     pairwise comparison, n_visible by __syncthreads_count and the partial
//     slots by ballots and popcount prefixes.
//   - CTAs 1..n_copy write the rest of P' in 16-byte units of the flat
//     index (D is odd at 109 and 373, so rows are not 16-byte aligned and
//     the map works on the flat index): a unit wholly inside the feature
//     block is one float4 copy; a unit that touches the camera rows or
//     columns takes each element's final value (F P for the camera rows and
//     columns, P for the feature block) and skips the camera block. Each of
//     these CTAs builds F itself with CTA 0's operations, so every CTA holds
//     the same bits and no CTA waits for another. Every flat element of P'
//     is written by exactly one CTA.
// The wrapper picks n_copy from D and the SMs (predict_measure.py::copy_ctas).
#include <cuda_runtime.h>
#include <stdint.h>

#include "measure_chain.cuh"

#define CAM_DIM 13
#define SLOT_DIM 6
#define MAX_MF 128
#define K1_THREADS 256

struct K1Params {
  float dt, half_dt, lin_var, ang_var;
  MeasConsts mc;
};

// The motion model's pieces in shared memory (motion_model.cpp:84-349, u = 0).
struct Motion {
  float F[CAM_DIM][CAM_DIM];
  float xs[7];       // predicted position and orientation
  float qt[4];       // q(omega dt)
  float trig[3];     // wn, sin(wn dt/2), cos(wn dt/2)
  int okw;
  float dOm[4][3];   // dqomegadt_by_domega
  float M[4][3];     // dq3_by_dq1(q) dOm
};

// Fills s.F, s.xs and s.M with all threads of the block (three barriers).
// Every entry runs the twin's operations (predict_measure.py::_predict_scalars),
// so every CTA gets the same bits.
__device__ void build_motion(const float* __restrict__ x, const K1Params& p, Motion& s) {
  const int tid = threadIdx.x;
  const float dt = p.dt, half = p.half_dt;
  if (tid == 0) {
    // quat_from_angular_velocity(w dt)
    const float av0 = x[10] * dt, av1 = x[11] * dt, av2 = x[12] * dt;
    const float angle = sqrtf(av0 * av0 + av1 * av1 + av2 * av2);
    const bool ok_a = angle > 0.0f;
    const float safe = ok_a ? angle : 1.0f;
    const float sfac = ok_a ? sinf(angle / 2.0f) / safe : 0.0f;
    s.qt[0] = ok_a ? cosf(angle / 2.0f) : 1.0f;
    s.qt[1] = sfac * av0;
    s.qt[2] = sfac * av1;
    s.qt[3] = sfac * av2;
  } else if (tid == 32) {
    // dqomegadt_by_domega's scalars
    const float w0 = x[10], w1 = x[11], w2 = x[12];
    const float wmod = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
    const bool okw = wmod > 0.0f;
    const float wn = okw ? wmod : 1.0f;
    s.trig[0] = wn;
    s.trig[1] = sinf(wn * half);
    s.trig[2] = cosf(wn * half);
    s.okw = okw;
  } else if (tid >= 64 && tid < 67) {
    const int i = tid - 64;
    s.xs[i] = x[i] + x[7 + i] * dt;
  }
  for (int e = tid; e < CAM_DIM * CAM_DIM; e += blockDim.x) {
    const int i = e / CAM_DIM, j = e - i * CAM_DIM;
    s.F[i][j] = i == j ? 1.0f : 0.0f;
  }
  __syncthreads();
  if (tid < 12) {
    const int a = tid / 3, b = tid - a * 3;  // dOm[a][b]
    const bool okw = s.okw != 0;
    const float wn = s.trig[0], s_ = s.trig[1], c_ = s.trig[2];
    float v;
    if (a == 0) {
      v = okw ? -half * (x[10 + b] / wn) * s_ : 0.0f;
    } else {
      const float wA = x[10 + a - 1], wB = x[10 + b];
      if (a - 1 == b)
        v = okw ? half * (wA * wA) / (wn * wn) * c_ + (1.0f / wn) * (1.0f - wA * wA / (wn * wn)) * s_
                : half;
      else
        v = okw ? (wA * wB / (wn * wn)) * (half * c_ - (1.0f / wn) * s_) : 0.0f;
    }
    s.dOm[a][b] = v;
  } else if (tid >= 32 && tid < 48) {
    // F's quaternion block dq3_by_dq2(qt)
    const int i = (tid - 32) >> 2, j = (tid - 32) & 3;
    const float tw = s.qt[0], tx = s.qt[1], ty = s.qt[2], tz = s.qt[3];
    const float qb[4][4] = {{tw, -tx, -ty, -tz}, {tx, tw, tz, -ty}, {ty, -tz, tw, tx}, {tz, ty, -tx, tw}};
    s.F[3 + i][3 + j] = qb[i][j];
  } else if (tid >= 64 && tid < 68) {
    // q' = q * qt
    const float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
    const float tw = s.qt[0], tx = s.qt[1], ty = s.qt[2], tz = s.qt[3];
    const int i = tid - 64;
    float v;
    if (i == 0) v = qw * tw - qx * tx - qy * ty - qz * tz;
    else if (i == 1) v = qw * tx + qx * tw + qy * tz - qz * ty;
    else if (i == 2) v = qw * ty - qx * tz + qy * tw + qz * tx;
    else v = qw * tz + qx * ty - qy * tx + qz * tw;
    s.xs[3 + i] = v;
  } else if (tid >= 96 && tid < 99) {
    s.F[tid - 96][7 + tid - 96] = dt;
  }
  __syncthreads();
  if (tid < 12) {
    const int i = tid / 3, j = tid - i * 3;
    const float qw = x[3], qx = x[4], qy = x[5], qz = x[6];
    const float D1[4][4] = {{qw, -qx, -qy, -qz}, {qx, qw, -qz, qy}, {qy, qz, qw, -qx}, {qz, -qy, qx, qw}};
    const float m = D1[i][0] * s.dOm[0][j] + D1[i][1] * s.dOm[1][j] + D1[i][2] * s.dOm[2][j] +
                    D1[i][3] * s.dOm[3][j];
    s.M[i][j] = m;
    s.F[3 + i][10 + j] = m;
  }
  __syncthreads();
}

// (F P)[i][j] for a camera row i < 13: k ascending, as the twin's top
__device__ __forceinline__ float fp_entry(const float (*F)[CAM_DIM], const float* __restrict__ P, int D,
                                          int i, int j) {
  float acc = F[i][0] * __ldg(P + j);
#pragma unroll
  for (int k = 1; k < CAM_DIM; ++k) acc = acc + F[i][k] * __ldg(P + k * D + j);
  return acc;
}

// CTAs 1..n_copy: P' outside the camera block, 16-byte units of the flat index
__device__ void copy_units(const float* __restrict__ P, float* __restrict__ Po, int D, const Motion& s,
                           int n_copy, bool vec) {
  const int N = D * D;
  const int n_units = (N + 3) / 4;
  const int per = (n_units + n_copy - 1) / n_copy;
  const int q0 = (blockIdx.x - 1) * per;
  const int q1 = min(q0 + per, n_units);
  for (int q = q0 + (int)threadIdx.x; q < q1; q += blockDim.x) {
    const int e0 = 4 * q;
    int i = e0 / D, j = e0 - i * D;
    if (vec && i >= CAM_DIM && j >= CAM_DIM && j + 3 < D && e0 + 3 < N) {
      reinterpret_cast<float4*>(Po)[q] = __ldg(reinterpret_cast<const float4*>(P) + q);
      continue;
    }
    for (int e = e0; e < e0 + 4 && e < N; ++e) {
      if (i >= CAM_DIM && j >= CAM_DIM) Po[e] = __ldg(P + e);
      else if (i < CAM_DIM && j >= CAM_DIM) Po[e] = fp_entry(s.F, P, D, i, j);
      else if (i >= CAM_DIM) Po[e] = fp_entry(s.F, P, D, j, i);  // camera column: (F P)'
      // the camera block is CTA 0's
      if (++j == D) {
        j = 0;
        ++i;
      }
    }
  }
}

__global__ void __launch_bounds__(K1_THREADS)
k1_kernel(const float* __restrict__ x, const float* __restrict__ P,
          const float* __restrict__ xp_org, const uint8_t* __restrict__ act_full,
          const uint8_t* __restrict__ act_part, float* __restrict__ meas,
          float* __restrict__ sel, float* __restrict__ xo, float* __restrict__ Po,
          int* __restrict__ top_idx, float* __restrict__ top_score,
          int* __restrict__ n_visible, int* __restrict__ pidx,
          uint8_t* __restrict__ pmask, int D, int MF, int NSEL, int MAXP, int n_copy, int vec,
          K1Params p) {
  __shared__ Motion s;
  build_motion(x, p, s);
  if (blockIdx.x > 0) {
    copy_units(P, Po, D, s, n_copy, vec != 0);
    return;
  }

  // ---- CTA 0: the critical path
  __shared__ float Q[CAM_DIM][CAM_DIM], topc[CAM_DIM][CAM_DIM], Pc[CAM_DIM][CAM_DIM];
  __shared__ float pxy_s[MAX_MF][7][3];
  __shared__ float work[MAX_MF];
  __shared__ int wpart[K1_THREADS / 32];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_cc = CAM_DIM * CAM_DIM;

  // Q = G Pnn G' (motion_model.cpp:148-217); the camera block of F P; the
  // camera rows 0..6 of F P at each slot's three columns
  for (int e = tid; e < 2 * n_cc + 21 * MF; e += nt) {
    if (e < n_cc) {
      const int i = e / CAM_DIM, j = e - i * CAM_DIM;
      float Gi[6], Gj[6];
      for (int r = 0; r < 2; ++r) {
        const int row = r == 0 ? i : j;
        float* G = r == 0 ? Gi : Gj;
        for (int k = 0; k < 6; ++k) G[k] = 0.0f;
        if (row < 3) G[row] = p.dt;
        else if (row < 7) for (int k = 0; k < 3; ++k) G[3 + k] = s.M[row - 3][k];
        else if (row < 10) G[row - 7] = 1.0f;
        else G[3 + row - 10] = 1.0f;
      }
      const float pnn[6] = {p.lin_var, p.lin_var, p.lin_var, p.ang_var, p.ang_var, p.ang_var};
      float acc = (Gi[0] * pnn[0]) * Gj[0];
      for (int k = 1; k < 6; ++k) acc = acc + (Gi[k] * pnn[k]) * Gj[k];
      Q[i][j] = acc;
    } else if (e < 2 * n_cc) {
      const int f = e - n_cc, i = f / CAM_DIM, j = f - i * CAM_DIM;
      topc[i][j] = fp_entry(s.F, P, D, i, j);
    } else {
      const int f = e - 2 * n_cc, lane = f / 21, r = f - lane * 21, a = r / 3, j = r - a * 3;
      pxy_s[lane][a][j] = fp_entry(s.F, P, D, a, CAM_DIM + SLOT_DIM * lane + j);
    }
  }
  __syncthreads();
  // A = top[:, :13] F' + Q and Pc = 0.5 (A + A'); each thread forms both A
  // entries of its Pc entry
  for (int e = tid; e < n_cc; e += nt) {
    const int i = e / CAM_DIM, j = e - i * CAM_DIM;
    float aij = topc[i][0] * s.F[j][0], aji = topc[j][0] * s.F[i][0];
    for (int k = 1; k < CAM_DIM; ++k) {
      aij = aij + topc[i][k] * s.F[j][k];
      aji = aji + topc[j][k] * s.F[i][k];
    }
    const float pc = 0.5f * ((aij + Q[i][j]) + (aji + Q[j][i]));
    Pc[i][j] = pc;
    Po[i * D + j] = pc;
  }
  for (int e = tid; e < D; e += nt) xo[e] = e < 7 ? s.xs[e] : x[e];
  __syncthreads();

  // per-slot measurement chain
  float m[NOUT];
  bool vis = false, part = false;
  if (tid < MF) {
    const int off = CAM_DIM + SLOT_DIM * tid;
    float r[3] = {s.xs[0], s.xs[1], s.xs[2]};
    float q[4] = {s.xs[3], s.xs[4], s.xs[5], s.xs[6]};
    float pxx[7][7], y[3], xpo[7], pxy[7][3], pyy[3][3];
    for (int i = 0; i < 7; ++i)
      for (int j = 0; j < 7; ++j) pxx[i][j] = Pc[i][j];
    for (int j = 0; j < 3; ++j) y[j] = x[off + j];
    for (int j = 0; j < 7; ++j) xpo[j] = xp_org[tid * 7 + j];
    for (int a = 0; a < 7; ++a)
      for (int j = 0; j < 3; ++j) pxy[a][j] = pxy_s[tid][a][j];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) pyy[i][j] = P[(off + i) * D + off + j];
    const bool full = act_full[tid] != 0;
    measure_lane(r, q, pxx, y, xpo, pxy, pyy, full, p.mc, m);
    for (int k = 0; k < NOUT; ++k) meas[k * MF + tid] = m[k];
    const float sc = m[O_SCORE];
    work[tid] = isfinite(sc) ? sc : -3e38f;
    vis = full && m[O_VIS] == 0.0f;
    part = act_part[tid] != 0;
  }
  // partial slots: a ballot a warp, its count in shared memory
  const unsigned bal = __ballot_sync(0xffffffffu, part);
  const int warp = tid >> 5, lane = tid & 31;
  if (lane == 0) wpart[warp] = __popc(bal);
  const int nv = __syncthreads_count(vis);  // also the barrier for work[] and wpart[]

  if (tid < MF) {
    // stable descending rank (lax.top_k order: ties to the lowest lane)
    const float sc = work[tid];
    int rank = 0;
    for (int k2 = 0; k2 < MF; ++k2) {
      const float s2 = work[k2];
      rank += (s2 > sc) || (s2 == sc && k2 < tid);
    }
    if (rank < NSEL) {
      top_idx[rank] = tid;
      top_score[rank] = sc;
      for (int k = 0; k < NOUT; ++k) sel[k * NSEL + rank] = isfinite(m[k]) ? m[k] : 0.0f;
    }
    // the first MAXP partial lanes, lowest first, then the lowest others
    int below = __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < (MF + 31) / 32; ++w) {
      below += w < warp ? wpart[w] : 0;
      total += wpart[w];
    }
    const int pos = part ? below : total + (tid - below);
    if (pos < MAXP) {
      pidx[pos] = tid;
      pmask[pos] = part;
    }
  }
  if (tid == 0) *n_visible = nv;
}

extern "C" int k1_predict_measure(const float* x, const float* P, const float* xp_org,
                                  const uint8_t* act_full, const uint8_t* act_part, float* meas,
                                  float* sel, float* xo, float* Po, int* top_idx,
                                  float* top_score, int* n_visible, int* pidx, uint8_t* pmask,
                                  int D, int MF, int NSEL, int MAXP, int n_copy, const K1Params* p,
                                  void* stream) {
  if (MF < 1 || MF > MAX_MF || n_copy < 1) return (int)cudaErrorInvalidValue;
  // float4 units need 16-byte aligned P and P' (fresh allocations are)
  const int vec = ((((uintptr_t)P) | ((uintptr_t)Po)) & 15u) == 0;
  k1_kernel<<<1 + n_copy, K1_THREADS, 0, (cudaStream_t)stream>>>(
      x, P, xp_org, act_full, act_part, meas, sel, xo, Po, top_idx, top_score, n_visible, pidx,
      pmask, D, MF, NSEL, MAXP, n_copy, vec, *p);
  return (int)cudaGetLastError();
}

// An empty kernel on a grid of gx x gy CTAs of `threads` threads: its launch
// time is the floor under a kernel on that grid (chip_smoke.py reports it at
// one CTA of 32 beside the byte/operation bounds;
// scripts/ab_particle_kernels.py on K10b's grids).
__global__ void k0_empty() {}

extern "C" int k0_empty_launch(int gx, int gy, int threads, void* stream) {
  if (gx <= 0 || gy <= 0 || gy > 65535 || threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  k0_empty<<<dim3((unsigned)gx, (unsigned)gy), threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
