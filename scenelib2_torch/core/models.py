"""Feature measurement models: full 3D point and partially-initialised ray.

Port of scenelib2_tpu/core/models.py (reference full_feature_model.cpp,
feature_model.cpp, part_feature_model.cpp). Visibility flag bits match
full_feature_model.h:74-78.

Layouts:
  xp     = [r(3), q(4 wxyz)]                    position state
  y_full = [3] world point
  y_part = [rWi(3), hhatWi(3)] semi-infinite ray + free depth lambda (scalar)

The ray functions take their products with mm_seq (sums left to right), so
the state surgery that uses them (runtime/state.py) rounds the same on the
CPU and on the GPU.

Every function except part_predict_from_zeroed takes leading (lane, slot)
dimensions: the point, pose or ray lies in the LAST dimension and Jacobians
in the last two.
"""

from __future__ import annotations

import math

import torch

from scenelib2_torch.core import camera as cam_mod
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.core.quaternion import (
    dRq_times_a_by_dq,
    dqbar_by_dq,
    dvnorm_by_dv,
    mm_seq,
    quat_inverse,
    quat_to_rotation_matrix,
    seqsum,
)

LEFT_RIGHT_FAIL = 1
UP_DOWN_FAIL = 2
DISTANCE_FAIL = 4
ANGLE_FAIL = 8
BEHIND_CAMERA_FAIL = 16


def full_zeroedyi(y: torch.Tensor, xp: torch.Tensor):
    """Feature position in the robot frame + Jacobians
    (full_feature_model.cpp:67-101).

    Returns (zeroedyi[3], dzeroedyi_by_dxp[3,7], dzeroedyi_by_dyi[3,3])."""
    r, q = xp[..., 0:3], xp[..., 3:7]
    y_minus_r = y - r
    qRW = quat_inverse(q)
    RRW = quat_to_rotation_matrix(qRW)
    zeroed = mm_seq(RRW, y_minus_r[..., None])[..., 0]
    d_by_dq = mm_seq(dRq_times_a_by_dq(qRW, y_minus_r), dqbar_by_dq(y.dtype, y.device))
    RRW = RRW.expand(*d_by_dq.shape[:-2], 3, 3)
    return zeroed, torch.cat([-RRW, d_by_dq], dim=-1), RRW


def full_project(cam: CameraParams, y: torch.Tensor, xp: torch.Tensor):
    """(hi[2], zeroedyi[3]) of full_predict_measurement without the
    Jacobians, in the same arithmetic."""
    y_minus_r = y - xp[..., 0:3]
    RRW = quat_to_rotation_matrix(quat_inverse(xp[..., 3:7]))
    zeroed = mm_seq(RRW, y_minus_r[..., None])[..., 0]
    return cam_mod.project(cam, zeroed), zeroed


def full_predict_measurement(cam: CameraParams, y: torch.Tensor, xp: torch.Tensor):
    """hi and Jacobians for a 3D point (full_feature_model.cpp:178-195).

    Returns (hi[2], dhi_by_dxp[2,7], dhi_by_dyi[2,3], zeroedyi[3])."""
    zeroed, dz_by_dxp, dz_by_dyi = full_zeroedyi(y, xp)
    hi = cam_mod.project(cam, zeroed)
    dh_by_dz = cam_mod.project_jacobian(cam, zeroed)
    return hi, mm_seq(dh_by_dz, dz_by_dxp), mm_seq(dh_by_dz, dz_by_dyi), zeroed


def full_visibility_test(
    cam: CameraParams,
    xp: torch.Tensor,
    y: torch.Tensor,
    xp_orig: torch.Tensor,
    hi: torch.Tensor,
    image_search_boundary: float = 20.0,
    max_length_ratio: float = 2.0,
    max_angle_difference: float = math.pi / 4,
) -> torch.Tensor:
    """Bit-flag visibility test (full_feature_model.cpp:103-170); 0 == visible.
    Returns an int32 tensor of the leading (lane, slot) dimensions (0-dim
    for one feature). Norms and dot products are left-to-right sums."""
    def bit(cond, v):
        return torch.where(cond, v, 0).to(torch.int32)

    def rot(q, v):
        return mm_seq(quat_to_rotation_matrix(q), v[..., None])[..., 0]

    def norm(v):
        return torch.sqrt(seqsum([v[..., i] * v[..., i] for i in range(3)]))

    b = image_search_boundary
    flag = bit((hi[..., 0] < b) | (hi[..., 0] > cam.width - 1 - b), LEFT_RIGHT_FAIL)
    flag = flag | bit((hi[..., 1] < b) | (hi[..., 1] > cam.height - 1 - b), UP_DOWN_FAIL)
    zeroed, _, _ = full_zeroedyi(y, xp)
    flag = flag | bit(zeroed[..., 2] <= 0, BEHIND_CAMERA_FAIL)
    hLWi = rot(xp[..., 3:7], zeroed)
    zeroed_orig, _, _ = full_zeroedyi(y, xp_orig)
    hLWi_orig = rot(xp_orig[..., 3:7], zeroed_orig)
    mod = norm(hLWi)
    mod_orig = norm(hLWi_orig)
    length_ratio = mod / mod_orig
    flag = flag | bit(
        (length_ratio > max_length_ratio) | (length_ratio < 1.0 / max_length_ratio),
        DISTANCE_FAIL,
    )
    # clipped acos argument: the same comparison outcome as the reference's
    # NaN beyond +-1, without NaN propagation
    dot = seqsum([hLWi[..., i] * hLWi_orig[..., i] for i in range(3)])
    cosang = torch.clamp(dot / (mod * mod_orig), -1.0, 1.0)
    angle = torch.abs(torch.arccos(cosang))
    return flag | bit(angle > max_angle_difference, ANGLE_FAIL)


def innovation_covariance(Pxx, Pxy, Pyy, dh_by_dxv, dh_by_dy, R) -> torch.Tensor:
    """S_i = Hx Pxx Hx' + Hx Pxy Hy' + (Hx Pxy Hy')' + Hy Pyy Hy' + R
    (feature_model.cpp:99-116), products left to right (mm_seq); leading
    (lane, slot) dimensions broadcast."""
    t = mm_seq(mm_seq(dh_by_dxv, Pxy), dh_by_dy.mT)
    return (mm_seq(mm_seq(dh_by_dxv, Pxx), dh_by_dxv.mT) + t + t.mT
            + mm_seq(mm_seq(dh_by_dy, Pyy), dh_by_dy.mT) + R)


# ---------------------------------------------------------------------------
# Partially-initialised (ray) feature model — part_feature_model.cpp
# ---------------------------------------------------------------------------


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def part_init_ray(cam: CameraParams, h: torch.Tensor, xp: torch.Tensor):
    """Ray state from one measurement (part_feature_model.cpp:162-229).

    Returns (ypi[6], dypi_by_dxp[6,7], dypi_by_dhi[6,2])."""
    hLRi = cam_mod.unproject(cam, h)
    norm = torch.sqrt(seqsum([hLRi[..., i] * hLRi[..., i] for i in range(3)]))
    hLhatRi = hLRi / norm[..., None]
    q = xp[..., 3:7]
    RWR = quat_to_rotation_matrix(q)
    hLhatWi = mm_seq(RWR, hLhatRi[..., :, None])[..., 0]
    ypi = torch.cat([xp[..., 0:3], hLhatWi], dim=-1)
    lead = xp.shape[:-1]
    dxp = torch.zeros((*lead, 6, 7), dtype=xp.dtype, device=xp.device)
    dxp[..., 0:3, 0:3] = _eye3(xp)
    dxp[..., 3:6, 3:7] = dRq_times_a_by_dq(q, hLhatRi)
    dhi = torch.zeros((*lead, 6, 2), dtype=xp.dtype, device=xp.device)
    dhi[..., 3:6, :] = mm_seq(mm_seq(RWR, dvnorm_by_dv(hLRi)), cam_mod.unproject_jacobian(cam, h))
    return ypi, dxp, dhi


def part_zeroedyi(y: torch.Tensor, xp: torch.Tensor):
    """Ray in the robot frame + Jacobians (part_feature_model.cpp:80-144).

    Returns (zeroedyi[..., 6], dzeroedyi_by_dxp[..., 6, 7],
    dzeroedyi_by_dyi[..., 6, 6]); y [..., 6] and xp [..., 7] broadcast over
    leading (lane, slot) dimensions."""
    r, q = xp[..., 0:3], xp[..., 3:7]
    ri, hhat = y[..., 0:3], y[..., 3:6]
    y_minus_r = ri - r
    qRW = quat_inverse(q)
    RRW = quat_to_rotation_matrix(qRW)
    dqbar = dqbar_by_dq(y.dtype, y.device)
    zeroedri = mm_seq(RRW, y_minus_r[..., None])[..., 0]
    zeroedhhat = mm_seq(RRW, hhat[..., None])[..., 0]
    lead = zeroedri.shape[:-1]
    RRW = RRW.expand(*lead, 3, 3)
    dxp = torch.zeros((*lead, 6, 7), dtype=y.dtype, device=y.device)
    dxp[..., 0:3, 0:3] = -RRW
    dxp[..., 0:3, 3:7] = mm_seq(dRq_times_a_by_dq(qRW, y_minus_r), dqbar)
    dxp[..., 3:6, 3:7] = mm_seq(dRq_times_a_by_dq(qRW, hhat), dqbar)
    dyi = torch.zeros((*lead, 6, 6), dtype=y.dtype, device=y.device)
    dyi[..., 0:3, 0:3] = RRW
    dyi[..., 3:6, 3:6] = RRW
    return torch.cat([zeroedri, zeroedhhat], dim=-1), dxp, dyi


def part_predict_from_zeroed(cam: CameraParams, zeroed, dz_by_dxp, dz_by_dyi, lam):
    """Per-particle tail of the ray measurement prediction: the image point
    at depth lam and its Jacobians. Returns (hpi[2], dhpi_by_dxp[2,7],
    dhpi_by_dyi[2,6])."""
    hLR = zeroed[0:3] + lam * zeroed[3:6]
    hpi = cam_mod.project(cam, hLR)
    dh_by_dhLR = cam_mod.project_jacobian(cam, hLR)
    dhLR_by_dz = torch.cat([_eye3(zeroed), lam * _eye3(zeroed)], dim=1)
    J = mm_seq(dh_by_dhLR, dhLR_by_dz)
    return hpi, mm_seq(J, dz_by_dxp), mm_seq(J, dz_by_dyi)


def part_predict_measurement(cam: CameraParams, y, xp, lam):
    """hpi and Jacobians for a ray at depth lam (part_feature_model.cpp:231-265)."""
    zeroed, dz_by_dxp, dz_by_dyi = part_zeroedyi(y, xp)
    return part_predict_from_zeroed(cam, zeroed, dz_by_dxp, dz_by_dyi, lam)


def part_convert_to_full(y: torch.Tensor, lam: torch.Tensor):
    """yfi = ri + lambda*hhat + Jacobians (part_feature_model.cpp:267-287).

    Returns (yfi[3], dyfi_by_dypi[3,6], dyfi_by_dlambda[3,1]); y [..., 6]
    and lam [...] may carry leading dimensions."""
    ri, hhat = y[..., 0:3], y[..., 3:6]
    yfi = ri + lam[..., None] * hhat
    eye = _eye3(y).expand(*y.shape[:-1], 3, 3)
    T = torch.cat([eye, lam[..., None, None] * eye], dim=-1)
    return yfi, T, hhat[..., :, None]
