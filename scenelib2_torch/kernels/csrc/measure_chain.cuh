// Per-slot measurement-prediction chain, in pieces (K7 spreads a slot's
// pieces over threads) and whole on one thread (measure_lane, K1).
//
// The CUDA twin of scenelib2_torch/kernels/measure.py::measure_math (itself
// a port of scenelib2_tpu/kernels/pallas_measure.py::_measure_math).
// Expression for expression the same operations in the same order: sums
// left to right, constants rounded to f32 once on the host. Built with
// -fmad=false, so no multiply-add is contracted and every operation rounds
// as the plain version's separate tensor operations do.
#pragma once

#include <math.h>

// output row layout (measure.py O_*)
#define O_H 0
#define O_HX 2
#define O_HY 16
#define O_RD 22
#define O_S 23
#define O_SINV 26
#define O_VIS 29
#define O_ZZ 30
#define O_SCORE 31
#define NOUT 32

struct MeasConsts {
  float fku, fkv, u0c, v0c, two_kd1, neg_two_kd1, sd0, maxd;
  float bnd, u_hi, v_hi, max_len_ratio, inv_len_ratio, cos_max_angle;
};

__device__ __forceinline__ void rotmat(float w, float x, float y, float z, float R[3][3]) {
  float xx = 2.0f * x * x, yy = 2.0f * y * y, zz = 2.0f * z * z;
  float xy = 2.0f * x * y, xz = 2.0f * x * z, yz = 2.0f * y * z;
  float wx = 2.0f * w * x, wy = 2.0f * w * y, wz = 2.0f * w * z;
  R[0][0] = 1.0f - (yy + zz); R[0][1] = xy - wz;          R[0][2] = xz + wy;
  R[1][0] = xy + wz;          R[1][1] = 1.0f - (xx + zz); R[1][2] = yz - wx;
  R[2][0] = xz - wy;          R[2][1] = yz + wx;          R[2][2] = 1.0f - (xx + yy);
}

// G[i][c] = (dR_c @ a)[i] (feature_model.cpp:167-237)
__device__ __forceinline__ void drq_times_a(float w, float x, float y, float z,
                                            const float a[3], float G[3][4]) {
  const float a0 = a[0], a1 = a[1], a2 = a[2];
  G[0][0] = 2.0f * (w * a0 - z * a1 + y * a2);
  G[1][0] = 2.0f * (z * a0 + w * a1 - x * a2);
  G[2][0] = 2.0f * (-y * a0 + x * a1 + w * a2);
  G[0][1] = 2.0f * (x * a0 + y * a1 + z * a2);
  G[1][1] = 2.0f * (y * a0 - x * a1 - w * a2);
  G[2][1] = 2.0f * (z * a0 + w * a1 - x * a2);
  G[0][2] = 2.0f * (-y * a0 + x * a1 + w * a2);
  G[1][2] = 2.0f * (x * a0 + y * a1 + z * a2);
  G[2][2] = 2.0f * (-w * a0 + z * a1 - y * a2);
  G[0][3] = 2.0f * (-z * a0 - w * a1 + x * a2);
  G[1][3] = 2.0f * (w * a0 - z * a1 + y * a2);
  G[2][3] = 2.0f * (x * a0 + y * a1 + z * a2);
}

// The lane's camera rotations: R(qRW) with qRW = conj(q) / |q|^2 (Eigen
// inverse; q is near-unit, not unit), and R(q). The same for every slot.
struct MeasCam {
  float aw, ax, ay, az;  // qRW
  float RRW[3][3], RWR[3][3];
};

__device__ __forceinline__ void meas_cam(const float q[4], MeasCam& k) {
  const float qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float qq = qw * qw + qx * qx + qy * qy + qz * qz;
  k.aw = qw / qq;
  k.ax = -qx / qq;
  k.ay = -qy / qq;
  k.az = -qz / qq;
  rotmat(k.aw, k.ax, k.ay, k.az, k.RRW);
  rotmat(qw, qx, qy, qz, k.RWR);
}

// zed = RRW (y - r), the point in the camera frame
__device__ __forceinline__ void meas_zed(const float r[3], const MeasCam& k, const float y[3],
                                         float ymr[3], float zed[3]) {
  for (int j = 0; j < 3; ++j) ymr[j] = y[j] - r[j];
  for (int i = 0; i < 3; ++i)
    zed[i] = k.RRW[i][0] * ymr[0] + k.RRW[i][1] * ymr[1] + k.RRW[i][2] * ymr[2];
}

// The projection h, its Jacobians hx (2 x 7) and hy (2 x 3) and the
// measurement noise variance Rd of one slot.
__device__ __forceinline__ void meas_geom(const float r[3], const MeasCam& k, const float y[3],
                                          const MeasConsts& c, float zed[3], float* hu_o,
                                          float* hv_o, float hx[2][7], float hy[2][3],
                                          float* Rd_o) {
  float ymr[3];
  meas_zed(r, k, y, ymr, zed);

  // project (camera.cpp:90-114)
  const float invz = 1.0f / zed[2];
  const float ucx = -c.fku * zed[0] * invz;
  const float ucy = -c.fkv * zed[1] * invz;
  const float rad2 = ucx * ucx + ucy * ucy;
  const float dist = 1.0f + c.two_kd1 * rad2;
  const float d12 = sqrtf(dist);
  const float hu = ucx / d12 + c.u0c;
  const float hv = ucy / d12 + c.v0c;

  // projection Jacobian (camera.cpp:183-215)
  const float d32 = d12 * dist;
  const float cdi = c.neg_two_kd1 / d32;
  const float A00 = ucx * ucx * cdi + 1.0f / d12;
  const float A01 = ucx * ucy * cdi;
  const float A11 = ucy * ucy * cdi + 1.0f / d12;
  const float fkuz = c.fku * invz;
  const float fkvz = c.fkv * invz;
  const float du[2][3] = {{-fkuz, 0.0f, fkuz * zed[0] * invz}, {0.0f, -fkvz, fkvz * zed[1] * invz}};
  float dh[2][3];
  for (int kk = 0; kk < 3; ++kk) {
    dh[0][kk] = A00 * du[0][kk] + A01 * du[1][kk];
    dh[1][kk] = A01 * du[0][kk] + A11 * du[1][kk];
  }

  float G[3][4];
  drq_times_a(k.aw, k.ax, k.ay, k.az, ymr, G);
  for (int i = 0; i < 2; ++i) {
    for (int a = 0; a < 3; ++a)
      hx[i][a] = -(dh[i][0] * k.RRW[0][a] + dh[i][1] * k.RRW[1][a] + dh[i][2] * k.RRW[2][a]);
    for (int cc = 0; cc < 4; ++cc) {
      const float s = dh[i][0] * G[0][cc] + dh[i][1] * G[1][cc] + dh[i][2] * G[2][cc];
      hx[i][3 + cc] = cc == 0 ? s : -s;
    }
    for (int j = 0; j < 3; ++j)
      hy[i][j] = dh[i][0] * k.RRW[0][j] + dh[i][1] * k.RRW[1][j] + dh[i][2] * k.RRW[2][j];
  }

  // measurement noise (camera.cpp:282-300)
  const float du_c = hu - c.u0c;
  const float dv_c = hv - c.v0c;
  const float dc = sqrtf(du_c * du_c + dv_c * dv_c);
  const float sd = c.sd0 * (1.0f + dc / c.maxd);
  *Rd_o = sd * sd;
  *hu_o = hu;
  *hv_o = hv;
}

// One entry S[a][b] (a >= b) of Hx Pxx Hx' + Hx Pxy Hy' + (.)' + Hy Pyy Hy'
// (R not added): hxa, hya are row a of the Jacobians, hxb, hyb row b.
__device__ __forceinline__ float meas_S(const float pxx[7][7], const float pxy[7][3],
                                        const float pyy[3][3], const float hxa[7],
                                        const float hya[3], const float hxb[7],
                                        const float hyb[3]) {
  float v_b[7], w_b[7], p_b[3];
  for (int i = 0; i < 7; ++i) {
    float acc = pxx[i][0] * hxb[0];
    for (int j = 1; j < 7; ++j) acc = acc + pxx[i][j] * hxb[j];
    v_b[i] = acc;
  }
  for (int a = 0; a < 7; ++a) w_b[a] = pxy[a][0] * hyb[0] + pxy[a][1] * hyb[1] + pxy[a][2] * hyb[2];
  for (int i = 0; i < 3; ++i) p_b[i] = pyy[i][0] * hyb[0] + pyy[i][1] * hyb[1] + pyy[i][2] * hyb[2];
  float Sab = hxa[0] * v_b[0];
  float Tab = hxa[0] * w_b[0];
  for (int i = 1; i < 7; ++i) {
    Sab = Sab + hxa[i] * v_b[i];
    Tab = Tab + hxa[i] * w_b[i];
  }
  float Tba = 0.0f;
  for (int j = 0; j < 3; ++j) {
    float inner = pxy[0][j] * hxb[0];
    for (int i = 1; i < 7; ++i) inner = inner + pxy[i][j] * hxb[i];
    const float t = hya[j] * inner;
    Tba = j == 0 ? t : Tba + t;
  }
  const float Pab = hya[0] * p_b[0] + hya[1] * p_b[1] + hya[2] * p_b[2];
  return Sab + Tab + Tba + Pab;
}

// The visibility flags that need the capture pose xpo (full_feature_model.cpp:
// 103-170): 4 the length ratio, 8 the view angle, 16 behind the camera.
#define VIS_DIST 4
#define VIS_ANG 8
#define VIS_BEHIND 16
__device__ __forceinline__ int meas_vis_flags(const MeasCam& k, const float zed[3], const float y[3],
                                              const float xpo[7], const MeasConsts& c) {
  const bool fl_behind = zed[2] <= 0.0f;
  float hLW[3];
  for (int i = 0; i < 3; ++i)
    hLW[i] = k.RWR[i][0] * zed[0] + k.RWR[i][1] * zed[1] + k.RWR[i][2] * zed[2];
  const float qqo = xpo[3] * xpo[3] + xpo[4] * xpo[4] + xpo[5] * xpo[5] + xpo[6] * xpo[6];
  float RRWo[3][3], RWRo[3][3];
  rotmat(xpo[3] / qqo, -xpo[4] / qqo, -xpo[5] / qqo, -xpo[6] / qqo, RRWo);
  float ymro[3], zo[3], hLWo[3];
  for (int j = 0; j < 3; ++j) ymro[j] = y[j] - xpo[j];
  for (int i = 0; i < 3; ++i) zo[i] = RRWo[i][0] * ymro[0] + RRWo[i][1] * ymro[1] + RRWo[i][2] * ymro[2];
  rotmat(xpo[3], xpo[4], xpo[5], xpo[6], RWRo);
  for (int i = 0; i < 3; ++i) hLWo[i] = RWRo[i][0] * zo[0] + RWRo[i][1] * zo[1] + RWRo[i][2] * zo[2];
  const float mod = sqrtf(hLW[0] * hLW[0] + hLW[1] * hLW[1] + hLW[2] * hLW[2]);
  const float modo = sqrtf(hLWo[0] * hLWo[0] + hLWo[1] * hLWo[1] + hLWo[2] * hLWo[2]);
  const float lr = mod / modo;
  const bool fl_dist = (lr > c.max_len_ratio) || (lr < c.inv_len_ratio);
  const float dotp = hLW[0] * hLWo[0] + hLW[1] * hLWo[1] + hLW[2] * hLWo[2];
  float cosang = dotp / (mod * modo);
  cosang = cosang < -1.0f ? -1.0f : cosang;  // NaN stays NaN, as torch.clamp
  cosang = cosang > 1.0f ? 1.0f : cosang;
  const bool fl_ang = cosang < c.cos_max_angle;
  return (fl_dist ? VIS_DIST : 0) | (fl_ang ? VIS_ANG : 0) | (fl_behind ? VIS_BEHIND : 0);
}

// The visibility row: the image-border flags of h (1 left/right, 2 up/down)
// and the flags of meas_vis_flags, summed as floats (exact: small integers)
__device__ __forceinline__ float meas_vis(float hu, float hv, int flags, const MeasConsts& c) {
  const bool fl_lr = (hu < c.bnd) || (hu > c.u_hi);
  const bool fl_ud = (hv < c.bnd) || (hv > c.v_hi);
  return (fl_lr ? 1.0f : 0.0f) + (fl_ud ? 2.0f : 0.0f) + ((flags & VIS_DIST) ? 4.0f : 0.0f)
         + ((flags & VIS_ANG) ? 8.0f : 0.0f) + ((flags & VIS_BEHIND) ? 16.0f : 0.0f);
}

// S^-1 as (a, b, c) from the 2x2 Cholesky factor (monoslam.cpp:371-374 order)
__device__ __forceinline__ void meas_sinv(float S00, float S01, float S11, float sinv[3]) {
  const float l11 = sqrtf(S00);
  const float l21 = S01 / l11;
  const float l22 = sqrtf(S11 - l21 * l21);
  const float i11 = 1.0f / l11;
  const float i22 = 1.0f / l22;
  const float i21 = -l21 * i11 * i22;
  sinv[0] = i11 * i11 + i21 * i21;
  sinv[1] = i21 * i22;
  sinv[2] = i22 * i22;
}

// The whole chain for one slot on one thread (K1). r[3], q[4]: camera
// position; pxx[7][7]: camera covariance; y[3], xpo[7], pxy[7][3], pyy[3][3]:
// this slot's point, capture pose and covariance blocks; act: active and
// fully initialised. Writes out[NOUT].
__device__ void measure_lane(const float r[3], const float q[4], const float pxx[7][7],
                             const float y[3], const float xpo[7], const float pxy[7][3],
                             const float pyy[3][3], bool act, const MeasConsts& c,
                             float out[NOUT]) {
  MeasCam k;
  meas_cam(q, k);
  float zed[3], hu, hv, hx[2][7], hy[2][3], Rd;
  meas_geom(r, k, y, c, zed, &hu, &hv, hx, hy, &Rd);
  const float S00 = meas_S(pxx, pxy, pyy, hx[0], hy[0], hx[0], hy[0]) + Rd;
  const float S01 = meas_S(pxx, pxy, pyy, hx[1], hy[1], hx[0], hy[0]);
  const float S11 = meas_S(pxx, pxy, pyy, hx[1], hy[1], hx[1], hy[1]) + Rd;
  float sinv[3];
  meas_sinv(S00, S01, S11, sinv);
  const float vis = meas_vis(hu, hv, meas_vis_flags(k, zed, y, xpo, c), c);
  const bool visible = act && (vis == 0.0f);

  out[O_H] = hu;
  out[O_H + 1] = hv;
  for (int i = 0; i < 2; ++i)
    for (int a = 0; a < 7; ++a) out[O_HX + 7 * i + a] = hx[i][a];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 3; ++j) out[O_HY + 3 * i + j] = hy[i][j];
  out[O_RD] = Rd;
  out[O_S] = S00;
  out[O_S + 1] = S01;
  out[O_S + 2] = S11;
  out[O_SINV] = sinv[0];
  out[O_SINV + 1] = sinv[1];
  out[O_SINV + 2] = sinv[2];
  out[O_VIS] = vis;
  out[O_ZZ] = zed[2];
  out[O_SCORE] = visible ? S00 + S11 : -INFINITY;
}
