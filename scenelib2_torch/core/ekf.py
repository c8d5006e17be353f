"""Dense-covariance EKF on the packed (camera + feature-slot) state.

Port of scenelib2_tpu/core/ekf.py. One P[D,D] with D = 13 + 6*MAX_F is the
storage; each feature slot owns a fixed 6-wide stride.

  predict   — kalman.cpp:50-69:   xv<-fv, Pxx<-F Pxx F'+Q, Pxy_i<-F Pxy_i
  update    — kalman.cpp:72-119:  S = H P H' + R, Cholesky inverse,
              W = P H' S^-1, x += W nu, P -= W S W'; failed measurement rows
              are masked with H=0, nu=0, R=I
  normalise — monoslam.cpp:616-637 via the quirk Jacobian (core.motion)
  symmetrize— monoslam.cpp:145-150: P <- P/2 + P'/2

The per-frame step runs these stages through the fused kernels in
scenelib2_torch/kernels. Their plain twins take the 2x2 inverse and
symmetrize from here; the matrix forms of predict, normalise and
joint_update are the f64 reference the twins are tested against
(tests/test_torch_core.py), since the kernels sum in their own order.

The batch step (runtime/step.py::make_batch_step), and the single-stream
step's split route above D = 384 through the same lane-form code, call
predict, joint_update, normalise and symmetrize directly, as the JAX step
does outside any kernel (the split route inverts S with K14): every
function here takes leading (lane) dimensions, x [..., D] and P [..., D, D]. Every product is taken with
mm_seq (each entry summed left to right in separately rounded operations),
so the batch step rounds the same on the CPU and on the GPU; a BLAS product
would round differently on each.
"""

from __future__ import annotations

import torch

from scenelib2_torch.core import motion
from scenelib2_torch.core.quaternion import mm_seq
from scenelib2_torch.kernels.chol_inv import chol_inv
from scenelib2_torch.runtime import telemetry

CAM_DIM = 13


def predict(x, P, u, delta_t: float, sd_a: float, sd_alpha: float):
    """EKF predict on the packed state; feature rows/cols other than the
    camera cross-terms are untouched. Its kernels count under the step
    region ``ekf.predict`` when a graph is captured."""
    with telemetry.region("ekf.predict"):
        fv, F = motion.func_fv_and_dfv_by_dxv(x[..., :CAM_DIM], u, delta_t)
        Q = motion.func_Q(x[..., :CAM_DIM], delta_t, sd_a, sd_alpha)
        return _camera_transform(x, P, fv, F, Q)


def _camera_transform(x, P, xv, F, Q=None):
    """x with its camera part replaced by xv, and P with its camera rows
    F P[cam, :], their transpose as its camera columns and the camera block
    F Pxx F' (+ Q)."""
    top = mm_seq(F, P[..., :CAM_DIM, :])
    pxx = mm_seq(top[..., :, :CAM_DIM], F.mT)
    if Q is not None:
        pxx = pxx + Q
    P = P.clone()
    P[..., :CAM_DIM, :] = top
    P[..., :, :CAM_DIM] = top.mT
    P[..., :CAM_DIM, :CAM_DIM] = pxx
    x = x.clone()
    x[..., :CAM_DIM] = xv
    return x, P


def normalise(x, P):
    """Quaternion-normalisation covariance transform; the state itself is
    unchanged (reference quirk)."""
    xv, J = motion.func_xvnorm_and_dxvnorm_by_dxv(x[..., :CAM_DIM])
    return _camera_transform(x, P, xv, J)


def chol2x2_parts(s00, s10, s11):
    """Lower Cholesky factor (l11, l21, l22) of a 2x2 SPD matrix from its
    entries (Eigen LLT order); 0-dim or per-slot [MF] tensors."""
    l11 = torch.sqrt(s00)
    l21 = s10 / l11
    l22 = torch.sqrt(s11 - l21 * l21)
    return l11, l21, l22


def chol2x2(S):
    """Lower Cholesky factor of a 2x2 SPD matrix."""
    l11, l21, l22 = chol2x2_parts(S[0, 0], S[1, 0], S[1, 1])
    zero = torch.zeros_like(l11)
    return torch.stack([torch.stack([l11, zero]), torch.stack([l21, l22])])


def inv2x2_via_chol_parts(s00, s10, s11):
    """Entries (a, b, c) of S^-1 = [[a, b], [b, c]] = L^-T L^-1 as the
    reference computes it (monoslam.cpp:371-374)."""
    l11, l21, l22 = chol2x2_parts(s00, s10, s11)
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i21 = -l21 * i11 * i22
    return i11 * i11 + i21 * i21, i21 * i22, i22 * i22


def inv2x2_via_chol(S):
    """S^-1 of 2x2 SPD matrices S [..., 2, 2] through their Cholesky factors."""
    a, b, c = inv2x2_via_chol_parts(S[..., 0, 0], S[..., 1, 0], S[..., 1, 1])
    return torch.stack([torch.stack([a, b], dim=-1), torch.stack([b, c], dim=-1)], dim=-2)


def chol_unrolled(S):
    """Right-looking Cholesky in the reference's column order (Eigen LLT),
    S [..., M, M]."""
    M = S.shape[-1]
    L = torch.zeros_like(S)
    for j in range(M):
        if j == 0:
            d = torch.sqrt(S[..., 0, 0])
            L[..., :, 0] = S[..., :, 0] / d[..., None]
            L[..., 0, 0] = d
        else:
            lj = L[..., j, :j, None]
            d = torch.sqrt(S[..., j, j] - mm_seq(lj.mT, lj)[..., 0, 0])
            L[..., j + 1:, j] = ((S[..., j + 1:, j] - mm_seq(L[..., j + 1:, :j], lj)[..., 0])
                                 / d[..., None])
            L[..., j, j] = d
    return L


def tril_inv_unrolled(L):
    """Forward substitution: X = L^-1 for lower-triangular L [..., M, M]."""
    M = L.shape[-1]
    X = torch.zeros_like(L)
    eye = torch.eye(M, dtype=L.dtype, device=L.device)
    for i in range(M):
        if i == 0:
            X[..., 0, :] = eye[0] / L[..., 0, 0, None]
        else:
            X[..., i, :] = ((eye[i] - mm_seq(L[..., i, None, :i], X[..., :i, :])[..., 0, :])
                            / L[..., i, i, None])
    return X


def joint_update(x, P, H, nu, R, pallas_chol: bool = False, blas: bool = False):
    """Joint EKF update (kalman.cpp:96-119) through L, L^-1 and
    S^-1 = L^-T L^-1, as the reference does. Returns (x', P', S).

    pallas_chol=True takes L^-1 from K14 (kernels/chol_inv.py) where S is
    f32, as the JAX package's joint_update(pallas_chol=True) does on the
    single-stream split route (core/ekf.py:136-142: `pallas_chol and
    S.dtype == float32`); otherwise, the batch step (JAX's pallas_chol=not
    batch_mode) and every f64 step, it factors with chol_unrolled /
    tril_inv_unrolled.

    blas=True takes the update's products with torch.matmul (TF32 stays
    off) instead of mm_seq: the large-map frame (eval/benchmark.py), where
    mm_seq's [M, D, D] temporaries and D launches a product do not fit."""
    mm = torch.matmul if blas else mm_seq
    S = mm(mm(H, P), H.mT) + R
    if pallas_chol and S.dtype == torch.float32:
        Linv = chol_inv(S)
    else:
        Linv = tril_inv_unrolled(chol_unrolled(S))
    Sinv = mm(Linv.mT, Linv)
    W = mm(mm(P, H.mT), Sinv)
    return x + mm(W, nu[..., None])[..., 0], P - mm(mm(W, S), W.mT), S


def symmetrize(P):
    """P <- 0.5*P + 0.5*P' (monoslam.cpp:145-150)."""
    return P * 0.5 + P.mT * 0.5
