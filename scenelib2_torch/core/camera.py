"""Stateless pinhole camera with SceneLib2's negated-focal + radial model.

Port of scenelib2_tpu/core/camera.py, which replicates reference
scenelib2/camera.cpp (these conventions are part of the parity surface):

  project   (camera.cpp:90-114):  u_c = (-fku*x/z, -fkv*y/z),
            h = u_c / sqrt(1 + 2*kd1*|u_c|^2) + centre
  unproject (camera.cpp:133-154): u_c = (h-centre)/sqrt(1 - 2*kd1*|h-centre|^2),
            y = (u_c.x/-fku, u_c.y/-fkv, 1)
  projection_jacobian   (camera.cpp:183-215)
  unprojection_jacobian (camera.cpp:247-275)
  measurement_noise     (camera.cpp:282-300): sd*(1+d/dmax), R = var*I2

Every function takes its point in the LAST dimension, so leading (lane)
dimensions pass through with the unbatched arithmetic, element for element.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scenelib2_torch.config import Params
from scenelib2_torch.core.quaternion import mm_seq


def _k(v, like: torch.Tensor) -> torch.Tensor:
    """A constant as a 0-dim tensor on like's device, filled there (no host
    copy, so no synchronisation): dividing by a Python scalar becomes a
    multiply by its reciprocal on CUDA, which rounds differently."""
    return torch.full((), v, dtype=like.dtype, device=like.device)


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
        return torch.stack([_k(self.u0, like), _k(self.v0, like)])


def _mat(rows) -> torch.Tensor:
    """Nested [r][c] lists of equally-shaped tensors -> [..., r, c]."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def project(cam: CameraParams, y: torch.Tensor, wide: torch.dtype | None = None) -> torch.Tensor:
    """Camera-frame point [..., 3] -> distorted image coords [..., 2]. With
    wide (float64), the centre is added in that dtype, as the JAX package's
    f64 camera constants promote an f32 point in its x64 process."""
    y0, y1, y2 = y.unbind(-1)
    uc = torch.stack([-cam.fku * y0 / y2, -cam.fkv * y1 / y2], dim=-1)
    radius2 = uc[..., 0] * uc[..., 0] + uc[..., 1] * uc[..., 1]
    factor = torch.sqrt(1.0 + 2.0 * cam.kd1 * radius2)
    h = uc / factor[..., None]
    if wide is not None:
        h = h.to(wide)
    return h + cam.centre(h)


def project_jacobian(cam: CameraParams, y: torch.Tensor, wide: torch.dtype | None = None) -> torch.Tensor:
    """[..., 2, 3] dh/dy at camera point y (camera.cpp:183-215). With wide,
    the identity term and the product are in that dtype (project's
    wide)."""
    y0, y1, y2 = y.unbind(-1)
    fku_yz = cam.fku / y2
    fkv_yz = cam.fkv / y2
    zero = torch.zeros_like(y0)
    du_by_dy = _mat([[-fku_yz, zero, fku_yz * y0 / y2],
                     [zero, -fkv_yz, fkv_yz * y1 / y2]])
    uc = torch.stack([-cam.fku * y0 / y2, -cam.fkv * y1 / y2], dim=-1)
    outer = uc[..., :, None] * uc[..., None, :]
    radius2 = outer[..., 0, 0] + outer[..., 1, 1]
    distor = 1.0 + 2.0 * cam.kd1 * radius2
    distor1_2 = torch.sqrt(distor)
    distor3_2 = distor1_2 * distor
    eye = torch.eye(2, dtype=wide or y.dtype, device=y.device)
    dh_by_du = (outer * (-2.0 * cam.kd1 / distor3_2)[..., None, None]
                + eye / distor1_2[..., None, None])
    return mm_seq(dh_by_du, du_by_dy)


def unproject(cam: CameraParams, h: torch.Tensor) -> torch.Tensor:
    """Image coords [..., 2] -> camera-frame ray [..., 3] with z = 1
    (camera.cpp:133-154)."""
    c0 = h[..., 0] - cam.u0
    c1 = h[..., 1] - cam.v0
    radius2 = c0 * c0 + c1 * c1
    factor = torch.sqrt(1.0 - 2.0 * cam.kd1 * radius2)
    return torch.stack([c0 / factor / _k(-cam.fku, h), c1 / factor / _k(-cam.fkv, h),
                        torch.ones_like(c0)], dim=-1)


def unproject_jacobian(cam: CameraParams, h: torch.Tensor) -> torch.Tensor:
    """[..., 3, 2] dy/dh at image point h (camera.cpp:247-275). Rows 0 and 1 scale
    du/dh by -1/fku and -1/fkv; row 2 is zero (the zero terms of the
    reference's dy_by_du @ du_by_dh product add exact zeros)."""
    c0 = h[..., 0] - cam.u0
    c1 = h[..., 1] - cam.v0
    radius2 = c0 * c0 + c1 * c1
    distor = 1.0 - 2.0 * cam.kd1 * radius2
    distor1_2 = torch.sqrt(distor)
    distor3_2 = distor1_2 * distor
    g = _k(2.0 * cam.kd1, h) / distor3_2
    inv = 1.0 / distor1_2
    du = [[c0 * c0 * g + inv, c0 * c1 * g], [c1 * c0 * g, c1 * c1 * g + inv]]
    a, b = _k(-1.0 / cam.fku, h), _k(-1.0 / cam.fkv, h)
    zero = torch.zeros_like(c0)
    return _mat([[a * du[0][0], a * du[0][1]], [b * du[1][0], b * du[1][1]], [zero, zero]])


def measurement_noise(cam: CameraParams, h: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2] diagonal R; sd grows radially to 2x at the corners
    (camera.cpp:282-300)."""
    c0 = h[..., 0] - cam.u0
    c1 = h[..., 1] - cam.v0
    distance = torch.sqrt(c0 * c0 + c1 * c1)
    cen = cam.centre(h)
    max_distance = torch.sqrt(cen[0] * cen[0] + cen[1] * cen[1])
    sd = cam.sd * (1.0 + distance / max_distance)
    return torch.eye(2, dtype=h.dtype, device=h.device) * (sd * sd)[..., None, None]
