"""Constant-velocity motion model (13-dim camera state).

Port of scenelib2_tpu/core/motion.py (reference scenelib2/motion_model.cpp).
State layout xv = [r(3), q(4, wxyz), v(3), omega(3)]:

  fv / dfv_by_dxv  (:84-146):  r += v*dt, q <- q * q(omega*dt), v += u*dt
                               (func_fv alone is the value path, which the
                               f64 auto-init rolls forward Jacobian-free)
  Q                (:148-217): Q = G Pnn G^T, Pnn = diag(sd_a^2 dt^2 (x3),
                               sd_alpha^2 dt^2 (x3))
  xp / dxp_by_dxv  (:219-235)
  xvnorm / dxvnorm_by_dxv (:237-263): the reference never normalises the
    quaternion itself; only the covariance is transformed by dqnorm_by_dq.

xv may carry leading (lane) dimensions: [..., 13] gives [..., 13, 13].
"""

from __future__ import annotations

import torch

from scenelib2_torch.core.quaternion import (
    dq3_by_dq1,
    dq3_by_dq2,
    dqnorm_by_dq,
    dqomegadt_by_domega,
    mm_seq,
    quat_from_angular_velocity,
    quat_mul,
)


def extract_r_q_v_omega(xv: torch.Tensor):
    return xv[..., 0:3], xv[..., 3:7], xv[..., 7:10], xv[..., 10:13]


def func_fv(xv: torch.Tensor, u: torch.Tensor, delta_t: float) -> torch.Tensor:
    """State transition only, no Jacobian (motion_model.cpp:84-117 value
    path): the auto-init's future rollforward, which the reference runs
    Jacobian-free (monoslam.cpp:880-883)."""
    r, q, v, omega = extract_r_q_v_omega(xv)
    rnew = r + v * delta_t
    qnew = quat_mul(q, quat_from_angular_velocity(omega * delta_t))
    vnew = v + u * delta_t
    return torch.cat([rnew, qnew, vnew, omega], dim=-1)


def func_fv_and_dfv_by_dxv(xv: torch.Tensor, u: torch.Tensor, delta_t: float):
    """Returns (fv[13], dfv_by_dxv[13,13])."""
    r, q, v, omega = extract_r_q_v_omega(xv)
    rnew = r + v * delta_t
    qwt = quat_from_angular_velocity(omega * delta_t)
    qnew = quat_mul(q, qwt)
    vnew = v + u * delta_t
    fv = torch.cat([rnew, qnew, vnew, omega], dim=-1)

    F = torch.eye(13, dtype=xv.dtype, device=xv.device).expand(*xv.shape[:-1], 13, 13).clone()
    F[..., 0:3, 7:10] = torch.eye(3, dtype=xv.dtype, device=xv.device) * delta_t
    F[..., 3:7, 3:7] = dq3_by_dq2(qwt)
    F[..., 3:7, 10:13] = mm_seq(dq3_by_dq1(q), dqomegadt_by_domega(omega, delta_t))
    return fv, F


def func_Q(xv: torch.Tensor, delta_t: float, sd_a: float, sd_alpha: float) -> torch.Tensor:
    """Process noise Q[13,13] (motion_model.cpp:148-217)."""
    lin_var = sd_a * sd_a * delta_t * delta_t
    ang_var = sd_alpha * sd_alpha * delta_t * delta_t
    _, q, _, omega = extract_r_q_v_omega(xv)
    kw = dict(dtype=xv.dtype, device=xv.device)
    G = torch.zeros((*xv.shape[:-1], 13, 6), **kw)
    G[..., 0:3, 0:3] = torch.eye(3, **kw) * delta_t
    G[..., 3:7, 3:6] = mm_seq(dq3_by_dq1(q), dqomegadt_by_domega(omega, delta_t))
    G[..., 7:10, 0:3] = torch.eye(3, **kw)
    G[..., 10:13, 3:6] = torch.eye(3, **kw)
    # the noise variances, filled on the device (no host copy)
    pnn = torch.diag(torch.cat([torch.full((3,), lin_var, **kw), torch.full((3,), ang_var, **kw)]))
    return mm_seq(mm_seq(G, pnn), G.mT)


def func_xp(xv: torch.Tensor) -> torch.Tensor:
    """Position state [r(3), q(4)] (motion_model.cpp:219-222)."""
    return xv[..., 0:7]


def dxp_by_dxv(dtype=torch.float64, device=None) -> torch.Tensor:
    """[7, 13] selector of the position state (motion_model.cpp:224-235)."""
    return torch.eye(7, 13, dtype=dtype, device=device)


def func_xvnorm_and_dxvnorm_by_dxv(xv: torch.Tensor):
    """Returns (xvnorm, J) with xvnorm == xv (the reference copies the
    quaternion without normalising it) and J the qq=|q|^2 quirk Jacobian."""
    J = torch.eye(13, dtype=xv.dtype, device=xv.device).expand(*xv.shape[:-1], 13, 13).clone()
    J[..., 3:7, 3:7] = dqnorm_by_dq(xv[..., 3:7])
    return xv, J
