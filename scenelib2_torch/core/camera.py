"""Stateless pinhole camera with SceneLib2's negated-focal + radial model.

Port of scenelib2_tpu/core/camera.py, which replicates reference
scenelib2/camera.cpp (these conventions are part of the parity surface):

  project   (camera.cpp:90-114):  u_c = (-fku*x/z, -fkv*y/z),
            h = u_c / sqrt(1 + 2*kd1*|u_c|^2) + centre
  projection_jacobian   (camera.cpp:183-215)
  measurement_noise     (camera.cpp:282-300): sd*(1+d/dmax), R = var*I2
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scenelib2_torch.config import Params


class CameraParams(NamedTuple):
    width: int
    height: int
    fku: float
    fkv: float
    u0: float
    v0: float
    kd1: float
    sd: float

    @staticmethod
    def from_params(p: Params) -> "CameraParams":
        return CameraParams(
            p.cam_width, p.cam_height, p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1, p.cam_sd
        )

    def centre(self, like: torch.Tensor) -> torch.Tensor:
        return torch.tensor([self.u0, self.v0], dtype=like.dtype, device=like.device)


def project(cam: CameraParams, y: torch.Tensor) -> torch.Tensor:
    """Camera-frame point [3] -> distorted image coords [2]."""
    uc = torch.stack([-cam.fku * y[0] / y[2], -cam.fkv * y[1] / y[2]])
    radius2 = uc[0] * uc[0] + uc[1] * uc[1]
    factor = torch.sqrt(1.0 + 2.0 * cam.kd1 * radius2)
    return uc / factor + cam.centre(y)


def project_jacobian(cam: CameraParams, y: torch.Tensor) -> torch.Tensor:
    """2x3 dh/dy at camera point y (camera.cpp:183-215)."""
    fku_yz = cam.fku / y[2]
    fkv_yz = cam.fkv / y[2]
    zero = torch.zeros_like(y[0])
    du_by_dy = torch.stack([
        torch.stack([-fku_yz, zero, fku_yz * y[0] / y[2]]),
        torch.stack([zero, -fkv_yz, fkv_yz * y[1] / y[2]]),
    ])
    uc = torch.stack([-cam.fku * y[0] / y[2], -cam.fkv * y[1] / y[2]])
    outer = torch.outer(uc, uc)
    radius2 = outer[0, 0] + outer[1, 1]
    distor = 1.0 + 2.0 * cam.kd1 * radius2
    distor1_2 = torch.sqrt(distor)
    distor3_2 = distor1_2 * distor
    eye = torch.eye(2, dtype=y.dtype, device=y.device)
    dh_by_du = outer * (-2.0 * cam.kd1 / distor3_2) + eye / distor1_2
    return dh_by_du @ du_by_dy


def measurement_noise(cam: CameraParams, h: torch.Tensor) -> torch.Tensor:
    """2x2 diagonal R; sd grows radially to 2x at the corners (camera.cpp:282-300)."""
    c = cam.centre(h)
    distance = torch.linalg.vector_norm(h - c)
    max_distance = torch.linalg.vector_norm(c)
    ratio = distance / max_distance
    sd = cam.sd * (1.0 + ratio)
    return torch.eye(2, dtype=h.dtype, device=h.device) * (sd * sd)
