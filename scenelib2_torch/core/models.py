"""Full 3D-point feature measurement model.

Port of the full-feature half of scenelib2_tpu/core/models.py (reference
full_feature_model.cpp and feature_model.cpp). The partially-initialised ray
model arrives with the particle stage. Visibility flag bits match
full_feature_model.h:74-78.
"""

from __future__ import annotations

import math

import torch

from scenelib2_torch.core import camera as cam_mod
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.core.quaternion import (
    dRq_times_a_by_dq,
    dqbar_by_dq,
    quat_inverse,
    quat_to_rotation_matrix,
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
    r, q = xp[0:3], xp[3:7]
    y_minus_r = y - r
    qRW = quat_inverse(q)
    RRW = quat_to_rotation_matrix(qRW)
    zeroed = RRW @ y_minus_r
    d_by_dq = dRq_times_a_by_dq(qRW, y_minus_r) @ dqbar_by_dq(y.dtype, y.device)
    return zeroed, torch.cat([-RRW, d_by_dq], dim=1), RRW


def full_predict_measurement(cam: CameraParams, y: torch.Tensor, xp: torch.Tensor):
    """hi and Jacobians for a 3D point (full_feature_model.cpp:178-195).

    Returns (hi[2], dhi_by_dxp[2,7], dhi_by_dyi[2,3], zeroedyi[3])."""
    zeroed, dz_by_dxp, dz_by_dyi = full_zeroedyi(y, xp)
    hi = cam_mod.project(cam, zeroed)
    dh_by_dz = cam_mod.project_jacobian(cam, zeroed)
    return hi, dh_by_dz @ dz_by_dxp, dh_by_dz @ dz_by_dyi, zeroed


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
    Returns a 0-dim int32 tensor."""
    def bit(cond, v):
        return torch.where(cond, v, 0).to(torch.int32)

    b = image_search_boundary
    flag = bit((hi[0] < b) | (hi[0] > cam.width - 1 - b), LEFT_RIGHT_FAIL)
    flag = flag | bit((hi[1] < b) | (hi[1] > cam.height - 1 - b), UP_DOWN_FAIL)
    zeroed, _, _ = full_zeroedyi(y, xp)
    flag = flag | bit(zeroed[2] <= 0, BEHIND_CAMERA_FAIL)
    hLWi = quat_to_rotation_matrix(xp[3:7]) @ zeroed
    zeroed_orig, _, _ = full_zeroedyi(y, xp_orig)
    hLWi_orig = quat_to_rotation_matrix(xp_orig[3:7]) @ zeroed_orig
    mod = torch.linalg.vector_norm(hLWi)
    mod_orig = torch.linalg.vector_norm(hLWi_orig)
    length_ratio = mod / mod_orig
    flag = flag | bit(
        (length_ratio > max_length_ratio) | (length_ratio < 1.0 / max_length_ratio),
        DISTANCE_FAIL,
    )
    # clipped acos argument: the same comparison outcome as the reference's
    # NaN beyond +-1, without NaN propagation
    cosang = torch.clamp(torch.dot(hLWi, hLWi_orig) / (mod * mod_orig), -1.0, 1.0)
    angle = torch.abs(torch.arccos(cosang))
    return flag | bit(angle > max_angle_difference, ANGLE_FAIL)


def innovation_covariance(Pxx, Pxy, Pyy, dh_by_dxv, dh_by_dy, R) -> torch.Tensor:
    """S_i = Hx Pxx Hx' + Hx Pxy Hy' + (Hx Pxy Hy')' + Hy Pyy Hy' + R
    (feature_model.cpp:99-116)."""
    t = dh_by_dxv @ Pxy @ dh_by_dy.T
    return dh_by_dxv @ Pxx @ dh_by_dxv.T + t + t.T + dh_by_dy @ Pyy @ dh_by_dy.T + R
