"""Quaternion and rotation-derivative primitives (wxyz convention).

Port of scenelib2_tpu/core/quaternion.py. The closed forms follow the
reference: quaternion product Jacobians (support/math_util.cpp:82-114),
QuaternionFromAngularVelocity (math_util.cpp:61-80), dqomegadt_by_domega
(motion_model.cpp:290-349, with the w->0 limit guarded), dqnorm_by_dq and
dvnorm_by_dv with the reference's qq = |q|^2 quirk (motion_model.cpp:351-380,
part_feature_model.cpp:300-335) and dRq_times_a_by_dq
(feature_model.cpp:167-237).

Each function has two forms. The ``*_parts`` form takes quaternions and
vectors as sequences of components (0-dim tensors, or [MF] tensors with one
value per feature slot) and returns the result's components as nested lists,
with every sum taken left to right: the plain twins of the kernels
(scenelib2_torch/kernels) evaluate it on slot lanes, and the CUDA kernels
perform the same operations in the same order. The tensor form takes
tensors whose LAST dimension holds the components and stacks the parts into
trailing dimensions, so any leading (lane) dimensions pass through: a
[B, 4] batch of quaternions gives [B, 3, 3] rotations with the arithmetic of
the unbatched call, element for element.
"""

from __future__ import annotations

import torch


def seqsum(terms):
    """Left-to-right sum of a list of tensors (the kernels' fixed order)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


def mm_seq(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A [..., m, K] @ B [..., K, n] with each entry summed over k left to
    right: the same rounding on every device (a BLAS product is free to
    reorder and to fuse multiply-adds). The products are taken in one
    elementwise op, each rounded once as in a product-then-add, then added
    in K - 1 ops."""
    prods = A[..., :, :, None] * B[..., None, :, :]
    acc = prods[..., 0, :]
    for k in range(1, A.shape[-1]):
        acc = acc + prods[..., k, :]
    return acc


def _depth(parts) -> int:
    return 1 + _depth(parts[0]) if isinstance(parts, (list, tuple)) else 0


def _stack(parts) -> torch.Tensor:
    """Nested lists of equally-shaped component tensors -> one tensor with
    the list levels as TRAILING dimensions (components [B] in a 3x4 nest give
    [B, 3, 4]; 0-dim components give [3, 4])."""
    d = _depth(parts)
    if d > 1:
        return torch.stack([_stack(p) for p in parts], dim=-d)
    return torch.stack(list(parts), dim=-1)


def quat_mul_parts(q1, q2) -> list:
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return [
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ]


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product q1 * q2, wxyz layout."""
    return _stack(quat_mul_parts(q1.unbind(-1), q2.unbind(-1)))


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -x, -y, -z], dim=-1)


def quat_inverse_parts(q) -> list:
    w, x, y, z = q
    qq = seqsum([w * w, x * x, y * y, z * z])
    return [w / qq, -x / qq, -y / qq, -z / qq]


def quat_inverse(q: torch.Tensor) -> torch.Tensor:
    """Eigen Quaternion::inverse(): conjugate / squaredNorm (the 1/|q|^2
    factor is part of the parity surface: the reference inverts near-unit
    quaternions with it, full_feature_model.cpp:76)."""
    return _stack(quat_inverse_parts(q.unbind(-1)))


def quat_to_rotation_parts(q) -> list:
    w, x, y, z = q
    s = 2.0
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return [
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ]


def quat_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Eigen toRotationMatrix() with the unit-quaternion assumption (factor 2,
    no renormalisation)."""
    return _stack(quat_to_rotation_parts(q.unbind(-1)))


def quat_from_angular_velocity_parts(av) -> list:
    a0, a1, a2 = av
    angle = torch.sqrt(a0 * a0 + a1 * a1 + a2 * a2)
    ok = angle > 0.0
    safe = torch.where(ok, angle, torch.ones_like(angle))
    s = torch.where(ok, torch.sin(angle / 2.0) / safe, torch.zeros_like(angle))
    c = torch.where(ok, torch.cos(angle / 2.0), torch.ones_like(angle))
    return [c, s * a0, s * a1, s * a2]


def quat_from_angular_velocity(av: torch.Tensor) -> torch.Tensor:
    """q(omega) = [cos(|av|/2), sin(|av|/2)/|av| * av]; identity at av=0."""
    return _stack(quat_from_angular_velocity_parts(av.unbind(-1)))


def dq3_by_dq1_parts(q1) -> list:
    w, x, y, z = q1
    return [[w, -x, -y, -z], [x, w, -z, y], [y, z, w, -x], [z, -y, x, w]]


def dq3_by_dq1(q1: torch.Tensor) -> torch.Tensor:
    """d(q1*q2)/dq2 expressed via q1 (math_util.cpp:82-97)."""
    return _stack(dq3_by_dq1_parts(q1.unbind(-1)))


def dq3_by_dq2_parts(q2) -> list:
    w, x, y, z = q2
    return [[w, -x, -y, -z], [x, w, z, -y], [y, -z, w, x], [z, y, -x, w]]


def dq3_by_dq2(q2: torch.Tensor) -> torch.Tensor:
    """d(q1*q2)/dq1 expressed via q2 (math_util.cpp:99-114)."""
    return _stack(dq3_by_dq2_parts(q2.unbind(-1)))


def dqomegadt_by_domega_parts(omega, delta_t: float) -> list:
    ox, oy, oz = omega
    wmod = torch.sqrt(ox * ox + oy * oy + oz * oz)
    ok = wmod > 0.0
    w = torch.where(ok, wmod, torch.ones_like(wmod))
    half = delta_t / 2.0
    s = torch.sin(w * half)
    c = torch.cos(w * half)
    zero = torch.zeros_like(wmod)

    def dq0_by_dA(wA):
        return torch.where(ok, -half * (wA / w) * s, zero)

    def dqA_by_dA(wA):
        val = half * (wA * wA) / (w * w) * c + (1.0 / w) * (1.0 - wA * wA / (w * w)) * s
        return torch.where(ok, val, torch.full_like(wmod, half))

    def dqA_by_dB(wA, wB):
        val = (wA * wB / (w * w)) * (half * c - (1.0 / w) * s)
        return torch.where(ok, val, zero)

    return [
        [dq0_by_dA(ox), dq0_by_dA(oy), dq0_by_dA(oz)],
        [dqA_by_dA(ox), dqA_by_dB(ox, oy), dqA_by_dB(ox, oz)],
        [dqA_by_dB(oy, ox), dqA_by_dA(oy), dqA_by_dB(oy, oz)],
        [dqA_by_dB(oz, ox), dqA_by_dB(oz, oy), dqA_by_dA(oz)],
    ]


def dqomegadt_by_domega(omega: torch.Tensor, delta_t: float) -> torch.Tensor:
    """4x3 Jacobian of q(omega*dt) wrt omega (motion_model.cpp:290-349); the
    omega->0 singularity returns the analytic limits."""
    return _stack(dqomegadt_by_domega_parts(omega.unbind(-1), delta_t))


def norm_jac_parts(v) -> list:
    """Reference 'normalisation Jacobian' with the qq=|v|^2 quirk (a literal
    transcription of dqi_by_dqi/dqi_by_dqj, motion_model.cpp:369-380,
    part_feature_model.cpp:322-334): diagonal (1 - vi^2/qq^2)/qq,
    off-diagonal -vi*vj/qq^3. The true Jacobian of v/|v| only at |v| = 1."""
    n = len(v)
    qq = seqsum([c * c for c in v])
    return [[(1.0 - v[i] * v[i] / (qq * qq)) / qq if i == j else -(v[i] * v[j]) / (qq * qq * qq)
             for j in range(n)] for i in range(n)]


def dqnorm_by_dq(q: torch.Tensor) -> torch.Tensor:
    """4x4 quaternion-normalisation Jacobian (motion_model.cpp:351-367)."""
    return _stack(norm_jac_parts(q.unbind(-1)))


def dvnorm_by_dv(v: torch.Tensor) -> torch.Tensor:
    """3x3 vector-normalisation Jacobian (part_feature_model.cpp:300-320)."""
    return _stack(norm_jac_parts(v.unbind(-1)))


def dqbar_by_dq(dtype=torch.float64, device=None) -> torch.Tensor:
    """Jacobian of conjugation (feature_model.cpp:155-165). Built on the
    device (writing a Python number into a CUDA tensor is a blocking copy)."""
    d = torch.where(torch.arange(4, device=device) == 0, 1.0, -1.0).to(dtype)
    return torch.diag(d)


def dRq_times_a_by_dq_parts(q, a) -> list:
    w, x, y, z = q
    a0, a1, a2 = a
    # column c = dR_c @ a
    cols = [
        [2 * (w * a0 - z * a1 + y * a2),
         2 * (z * a0 + w * a1 - x * a2),
         2 * (-y * a0 + x * a1 + w * a2)],
        [2 * (x * a0 + y * a1 + z * a2),
         2 * (y * a0 - x * a1 - w * a2),
         2 * (z * a0 + w * a1 - x * a2)],
        [2 * (-y * a0 + x * a1 + w * a2),
         2 * (x * a0 + y * a1 + z * a2),
         2 * (-w * a0 + z * a1 - y * a2)],
        [2 * (-z * a0 - w * a1 + x * a2),
         2 * (w * a0 - z * a1 + y * a2),
         2 * (x * a0 + y * a1 + z * a2)],
    ]
    return [[cols[c][i] for c in range(4)] for i in range(3)]


def dRq_times_a_by_dq(q: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    """3x4 Jacobian of R(q) @ a wrt q, from the unnormalised-R derivative
    blocks dR_by_dq{0,x,y,z} (feature_model.cpp:167-237)."""
    return _stack(dRq_times_a_by_dq_parts(q.unbind(-1), a.unbind(-1)))
