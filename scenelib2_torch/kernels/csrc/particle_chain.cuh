// Per-particle measurement prediction of a partial (ray) feature.
//
// The CUDA form of scenelib2_torch/kernels/particle.py (geometry_prologue,
// particle_tail), which ports scenelib2_tpu/kernels/pallas_particle.py
// (_geometry_prologue with _dot_row / _mat_mul_t / _drq_dqbar, and
// _particle_tail). Every float operation is the twin's, in its order: dot
// rows skip the literal zeros of N1 / N2 and start from their first term.
// Included by search_bayes.cu (K4), whose prologue runs it,
// particle_predict.cu (K10) and particle_kform.cu (K10b, the tail alone).
#pragma once

enum { ROW_HU, ROW_HV, ROW_S00, ROW_S01, ROW_S11, ROW_DET, ROW_HW, ROW_HH, NROWS };

struct ParticleConsts {
  float fku, fkv, u0c, v0c, two_kd1, neg_two_kd1, sd0, maxdist, no_sigma;
};

// geometry layout: zr[3] | zh[3] | K0[9] | Ksym[9] | K2[9]
#define GEOM_ZR 0
#define GEOM_ZH 3
#define GEOM_K0 6
#define GEOM_KS 15
#define GEOM_K2 24
#define GEOM_N 33

__device__ inline void drq_dqbar(float qw, float qx, float qy, float qz, const float a[3], float out[3][4]) {
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  const float col0[3] = {2.0f * (qw * a0 - qz * a1 + qy * a2), 2.0f * (qz * a0 + qw * a1 - qx * a2),
                         2.0f * (-qy * a0 + qx * a1 + qw * a2)};
  const float col1[3] = {2.0f * (qx * a0 + qy * a1 + qz * a2), 2.0f * (qy * a0 - qx * a1 - qw * a2),
                         2.0f * (qz * a0 + qw * a1 - qx * a2)};
  const float col2[3] = {2.0f * (-qy * a0 + qx * a1 + qw * a2), 2.0f * (qx * a0 + qy * a1 + qz * a2),
                         2.0f * (-qw * a0 + qz * a1 - qy * a2)};
  const float col3[3] = {2.0f * (-qz * a0 - qw * a1 + qx * a2), 2.0f * (qw * a0 - qz * a1 + qy * a2),
                         2.0f * (qx * a0 + qy * a1 + qz * a2)};
  for (int i = 0; i < 3; ++i) {
    out[i][0] = col0[i];
    out[i][1] = -col1[i];
    out[i][2] = -col2[i];
    out[i][3] = -col3[i];
  }
}

// entry (r, c) of C = [[Pxx7, Pxy7], [Pxy7', Pyy]] from the packed rows
__device__ __forceinline__ float cov_at(const float* sh, const float* sl, int r, int c) {
  if (r < 7 && c < 7) return sh[7 + 7 * r + c];
  if (r < 7) return sl[6 + 6 * r + (c - 7)];
  if (c < 7) return sl[6 + 6 * c + (r - 7)];
  return sl[48 + 6 * (r - 7) + (c - 7)];
}

// column t of the live columns of N1 (10: 0..9) and of N2 (7: 3..6, 10..12)
__device__ __forceinline__ int live_col(int n2, int t) { return n2 ? (t < 4 ? 3 + t : 6 + t) : t; }

// shared floats of geometry_prologue: the rows [56 + 84], C [13][13], N
// [2][3][13], C N' [2][13][3], K12 [3][3]
#define PROLOGUE_SCRATCH 474

// a dot row: sum over the live columns c of N1 (n2 = 0) or N2 of a[c * sa]
// b[c * sb], from the first term, in column order
__device__ __forceinline__ float live_dot(int n2, const float* a, int sa, const float* b, int sb) {
  int c = live_col(n2, 0);
  float d = a[c * sa] * b[c * sb];
  for (int t = 1; t < (n2 ? 7 : 10); ++t) {
    c = live_col(n2, t);
    d = d + a[c * sa] * b[c * sb];
  }
  return d;
}

// The slot geometry on every thread of the block (tid of nt >= 128 threads;
// the caller's barrier follows): the two packed rows copied to shared
// memory (every load in flight at once) and C laid out there; every thread
// forms R, the rotated vectors and N1, N2 (thread 0 writes zr, zh); then
// the 78 entries of C N1' and C N2', the 27 of K0, K12, K2 and the 9 of
// Ksym, each on one thread with the serial form's operations in its order
// (dot rows skip the literal zeros of N1 / N2 and start from their first
// term), the dots of one length on one warp. g and scratch: shared memory.
// shared_row: xp[7] + Pxx7 row-major [49]; slot_row: y6[6] + pxy7 [7][6] + pyy [6][6]
__device__ inline void geometry_prologue(const float* shared_row, const float* slot_row, float* g, float* scratch,
                                         int tid, int nt) {
  float* sh = scratch;            // [56]
  float* sl = scratch + 56;       // [84]
  float* Cs = scratch + 140;      // [13][13]
  float* Ns = scratch + 309;      // [2][3][13]
  float* CNs = scratch + 387;     // [2][13][3]
  float* K12s = scratch + 465;    // [3][3]
  {
    const int i0 = tid, i1 = tid + nt;  // 0 .. 55: shared_row, 56 .. 139: slot_row
    const float x0 = i0 < 56 ? shared_row[i0] : i0 < 140 ? slot_row[i0 - 56] : 0.0f;
    const float x1 = i1 < 56 ? shared_row[i1] : i1 < 140 ? slot_row[i1 - 56] : 0.0f;
    if (i0 < 140) scratch[i0] = x0;
    if (i1 < 140) scratch[i1] = x1;
  }
  __syncthreads();
  for (int e = tid; e < 169; e += nt) Cs[e] = cov_at(sh, sl, e / 13, e % 13);
  const float w = sh[3], x = sh[4], y = sh[5], z = sh[6];
  const float inv_n2 = 1.0f / (w * w + x * x + y * y + z * z);
  const float qw = w * inv_n2, qx = -x * inv_n2, qy = -y * inv_n2, qz = -z * inv_n2;
  const float wx = 2.0f * qw * qx, wy = 2.0f * qw * qy, wz = 2.0f * qw * qz;
  const float xx = 2.0f * qx * qx, xy = 2.0f * qx * qy, xz = 2.0f * qx * qz;
  const float yy = 2.0f * qy * qy, yz = 2.0f * qy * qz, zz = 2.0f * qz * qz;
  const float R[3][3] = {{1.0f - (yy + zz), xy - wz, xz + wy},
                         {xy + wz, 1.0f - (xx + zz), yz - wx},
                         {xz - wy, yz + wx, 1.0f - (xx + yy)}};
  float ym[3], hh[3];
  for (int i = 0; i < 3; ++i) {
    ym[i] = sl[i] - sh[i];
    hh[i] = sl[3 + i];
  }
  if (tid == 0)
    for (int i = 0; i < 3; ++i) {
      g[GEOM_ZR + i] = R[i][0] * ym[0] + R[i][1] * ym[1] + R[i][2] * ym[2];
      g[GEOM_ZH + i] = R[i][0] * hh[0] + R[i][1] * hh[1] + R[i][2] * hh[2];
    }
  float B1[3][4], B2[3][4];
  drq_dqbar(qw, qx, qy, qz, ym, B1);
  drq_dqbar(qw, qx, qy, qz, hh, B2);
  // N1 = [-R | B1 | R | 0] (columns 0..9 live), N2 = [0 | B2 | 0 | R]
  // (columns 3..6 and 10..12 live); thread e writes entry e
  float N[2][3][13];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int k = 0; k < 13; ++k) N[0][i][k] = N[1][i][k] = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      N[0][i][k] = -R[i][k];
      N[0][i][7 + k] = R[i][k];
      N[1][i][10 + k] = R[i][k];
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      N[0][i][3 + k] = B1[i][k];
      N[1][i][3 + k] = B2[i][k];
    }
  }
#pragma unroll
  for (int e = 0; e < 78; ++e)
    if (e == tid) Ns[e] = N[e / 39][(e % 39) / 13][e % 13];
  __syncthreads();
  // (C N1')[r][i] on threads 0 .. 38, (C N2')[r][i] on threads 64 .. 102
  if (tid < 39 || (tid >= 64 && tid < 103)) {
    const int n2 = tid >= 64, e = tid - 64 * n2, r = e / 3, i = e % 3;
    CNs[39 * n2 + e] = live_dot(n2, Cs + 13 * r, 1, Ns + 39 * n2 + 13 * i, 1);
  }
  __syncthreads();
  // K0 = N1 (C N1') and K12 = N1 (C N2') on threads 0 .. 17, K2 = N2 (C N2') on 32 .. 40
  if (tid < 18 || (tid >= 32 && tid < 41)) {
    const int kind = tid < 18 ? tid / 9 : 2, e = tid < 18 ? tid % 9 : tid - 32, i = e / 3, j = e % 3;
    const int n2 = kind == 2;
    const float a = live_dot(n2, Ns + 39 * n2 + 13 * i, 1, CNs + 39 * (kind != 0) + j, 3);
    if (kind == 0) g[GEOM_K0 + e] = a;
    else if (kind == 1) K12s[e] = a;
    else g[GEOM_K2 + e] = a;
  }
  __syncthreads();
  if (tid < 9) {
    const int i = tid / 3, j = tid % 3;
    g[GEOM_KS + 3 * i + j] = K12s[3 * i + j] + K12s[3 * j + i];
  }
}

__device__ inline void particle_tail(float lam, const float* g, const ParticleConsts& c, float out[NROWS]) {
  const float x = g[GEOM_ZR + 0] + lam * g[GEOM_ZH + 0];
  const float y = g[GEOM_ZR + 1] + lam * g[GEOM_ZH + 1];
  const float z = g[GEOM_ZR + 2] + lam * g[GEOM_ZH + 2];
  const float invz = 1.0f / z;
  const float ucx = -c.fku * x * invz;
  const float ucy = -c.fkv * y * invz;
  const float r2 = ucx * ucx + ucy * ucy;
  const float d = 1.0f + c.two_kd1 * r2;
  const float d12 = sqrtf(d);
  const float hu = ucx / d12 + c.u0c;
  const float hv = ucy / d12 + c.v0c;

  const float c1 = 1.0f / d12;
  const float c3 = c.neg_two_kd1 / (d12 * d);
  const float m00 = ucx * ucx * c3 + c1;
  const float m01 = ucx * ucy * c3;
  const float m11 = ucy * ucy * c3 + c1;
  const float j00 = -c.fku * invz;
  const float j11 = -c.fkv * invz;
  const float j02 = c.fku * x * invz * invz;
  const float j12 = c.fkv * y * invz * invz;
  const float a00 = m00 * j00, a01 = m01 * j11, a02 = m00 * j02 + m01 * j12;
  const float a10 = m01 * j00, a11 = m11 * j11, a12 = m01 * j02 + m11 * j12;

  const float lam2 = lam * lam;
  const float* K0 = g + GEOM_K0;
  const float* Ks = g + GEOM_KS;
  const float* K2 = g + GEOM_K2;
#define KL(i, j) (K0[3 * (i) + (j)] + lam * Ks[3 * (i) + (j)] + lam2 * K2[3 * (i) + (j)])
  const float k00 = KL(0, 0), k01 = KL(0, 1), k02 = KL(0, 2);
  const float k11 = KL(1, 1), k12 = KL(1, 2), k22 = KL(2, 2);
#undef KL
  const float t00 = a00 * k00 + a01 * k01 + a02 * k02;
  const float t01 = a00 * k01 + a01 * k11 + a02 * k12;
  const float t02 = a00 * k02 + a01 * k12 + a02 * k22;
  const float t10 = a10 * k00 + a11 * k01 + a12 * k02;
  const float t11 = a10 * k01 + a11 * k11 + a12 * k12;
  const float t12 = a10 * k02 + a11 * k12 + a12 * k22;
  float s00 = t00 * a00 + t01 * a01 + t02 * a02;
  const float s01 = t00 * a10 + t01 * a11 + t02 * a12;
  float s11 = t10 * a10 + t11 * a11 + t12 * a12;

  const float du = hu - c.u0c, dv = hv - c.v0c;
  const float dist = sqrtf(du * du + dv * dv);
  const float sd = c.sd0 * (1.0f + dist / c.maxdist);
  const float rr = sd * sd;
  s00 = s00 + rr;
  s11 = s11 + rr;
  const float det = s00 * s11 - s01 * s01;

  const float l11 = sqrtf(s00);
  const float l21 = s01 / l11;
  const float l22 = sqrtf(s11 - l21 * l21);
  const float i11 = 1.0f / l11;
  const float i22 = 1.0f / l22;
  const float i21 = -l21 * i11 * i22;
  const float q00 = i11 * i11 + i21 * i21;
  const float q01 = i21 * i22;
  const float q11 = i22 * i22;
  out[ROW_HU] = hu;
  out[ROW_HV] = hv;
  out[ROW_S00] = q00;
  out[ROW_S01] = q01;
  out[ROW_S11] = q11;
  out[ROW_DET] = det;
  out[ROW_HW] = floorf(c.no_sigma / sqrtf(q00 - q01 * q01 / q11));
  out[ROW_HH] = floorf(c.no_sigma / sqrtf(q11 - q01 * q01 / q00));
}
