// Per-particle measurement prediction of a partial (ray) feature.
//
// The CUDA form of scenelib2_torch/kernels/particle.py (geometry_prologue,
// particle_tail), which ports scenelib2_tpu/kernels/pallas_particle.py
// (_geometry_prologue with _dot_row / _mat_mul_t / _drq_dqbar, and
// _particle_tail). Every float operation is the twin's, in its order: dot
// rows skip the literal zeros of N1 / N2 and start from their first term.
// Included by search_bayes.cu (K4), whose prologue runs it.
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

// shared: xp[7] + Pxx7 row-major [49]; slot: y6[6] + pxy7 [7][6] + pyy [6][6]
__device__ inline void geometry_prologue(const float* sh, const float* sl, float* g) {
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
  for (int i = 0; i < 3; ++i) {
    g[GEOM_ZR + i] = R[i][0] * ym[0] + R[i][1] * ym[1] + R[i][2] * ym[2];
    g[GEOM_ZH + i] = R[i][0] * hh[0] + R[i][1] * hh[1] + R[i][2] * hh[2];
  }
  float B1[3][4], B2[3][4];
  drq_dqbar(qw, qx, qy, qz, ym, B1);
  drq_dqbar(qw, qx, qy, qz, hh, B2);
  // N1 = [-R | B1 | R | 0] (columns 0..9 live), N2 = [0 | B2 | 0 | R]
  // (columns 3..6 and 10..12 live)
  float N1[3][13], N2[3][13];
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 13; ++k) N1[i][k] = N2[i][k] = 0.0f;
    for (int k = 0; k < 3; ++k) {
      N1[i][k] = -R[i][k];
      N1[i][7 + k] = R[i][k];
      N2[i][10 + k] = R[i][k];
    }
    for (int k = 0; k < 4; ++k) {
      N1[i][3 + k] = B1[i][k];
      N2[i][3 + k] = B2[i][k];
    }
  }
  const int nz1[10] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9};
  const int nz2[7] = {3, 4, 5, 6, 10, 11, 12};
  // C = [[Pxx7, Pxy7], [Pxy7', Pyy]]
  float C[13][13];
  for (int r = 0; r < 13; ++r)
    for (int c = 0; c < 13; ++c) {
      if (r < 7 && c < 7) C[r][c] = sh[7 + 7 * r + c];
      else if (r < 7) C[r][c] = sl[6 + 6 * r + (c - 7)];
      else if (c < 7) C[r][c] = sl[6 + 6 * c + (r - 7)];
      else C[r][c] = sl[48 + 6 * (r - 7) + (c - 7)];
    }
  float CN1[13][3], CN2[13][3];
  for (int r = 0; r < 13; ++r)
    for (int i = 0; i < 3; ++i) {
      float a = C[r][nz1[0]] * N1[i][nz1[0]];
      for (int t = 1; t < 10; ++t) a = a + C[r][nz1[t]] * N1[i][nz1[t]];
      CN1[r][i] = a;
      float b = C[r][nz2[0]] * N2[i][nz2[0]];
      for (int t = 1; t < 7; ++t) b = b + C[r][nz2[t]] * N2[i][nz2[t]];
      CN2[r][i] = b;
    }
  float K12[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      float a = N1[i][nz1[0]] * CN1[nz1[0]][j];
      float b = N1[i][nz1[0]] * CN2[nz1[0]][j];
      for (int t = 1; t < 10; ++t) {
        a = a + N1[i][nz1[t]] * CN1[nz1[t]][j];
        b = b + N1[i][nz1[t]] * CN2[nz1[t]][j];
      }
      float c = N2[i][nz2[0]] * CN2[nz2[0]][j];
      for (int t = 1; t < 7; ++t) c = c + N2[i][nz2[t]] * CN2[nz2[t]][j];
      g[GEOM_K0 + 3 * i + j] = a;
      K12[i][j] = b;
      g[GEOM_K2 + 3 * i + j] = c;
    }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) g[GEOM_KS + 3 * i + j] = K12[i][j] + K12[j][i];
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
