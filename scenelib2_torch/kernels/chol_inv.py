"""K14: L^-1 of SPD matrices by Cholesky and forward substitution.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_linalg.py
(``pallas_chol_inv_lower`` / ``_chol_inv_kernel``, body ``chol_linv_body``,
pallas_linalg.py:29-90). The joint EKF update inverts its innovation
covariance S [M, M] (M = 2 NSEL = 20) through the factor, as the reference
does (kalman.cpp:104-107: LLT, L^-1, S^-1 = L^-T L^-1); the single-stream
step's split route, taken once D > 384, calls this from
core/ekf.py::joint_update.

Bound on an H100 at M = 20: 1.6 KB in, 1.6 KB out and ~5 k operations,
nanoseconds; the launch and the 2M dependent steps of the recurrence are
the cost. Design (csrc/chol_inv.cu): at M <= 32 one warp a matrix, four a
CTA, the matrix in the warp's registers (column l in lane l, the other
columns' entries by shuffle: no shared memory, no barrier), from a build
whose M is fixed when compiled (reg_defines: a library for each M that
the caller's matrices have); at M > 32 one block a matrix, S, U and X in
shared memory, each step one block-wide pass. The recurrences are
csrc/chol_linv.cuh, which K3 (csrc/ekf_update.cu) runs too.
"""

from __future__ import annotations

import ctypes

import torch

from scenelib2_torch.core.quaternion import seqsum
from scenelib2_torch.kernels import _build

NAME = "chol_inv"
MAX_M = 128
REG_MAX_M = 32   # the largest M of the register form: a lane a column


def reg_defines(M: int) -> tuple:
    """The build defines that give chol_linv.cuh's register form at M (a
    library of its own for each M, kernels/_build.py); none above
    REG_MAX_M."""
    return (("CHOL_REG_M", M),) if M <= REG_MAX_M else ()


def chol_linv(S: torch.Tensor) -> torch.Tensor:
    """L^-1 of SPD S [..., M, M] by the recurrences of chol_linv_body
    (pallas_linalg.py:29-64): right-looking factorisation with the factor
    stored transposed (U = L'), then forward substitution L X = I with the
    row sums taken in ascending order. The plain version of K14, and K3's
    factorisation."""
    M = S.shape[-1]
    A = S.clone()
    U = torch.zeros_like(S)
    for j in range(M):
        d = A[..., j, j]
        inv_sqrt = 1.0 / torch.sqrt(d)
        U[..., j, j:] = A[..., j, j:] * inv_sqrt[..., None]
        A[..., j + 1:, j + 1:] = (A[..., j + 1:, j + 1:]
                                  - A[..., j + 1:, j : j + 1] * (A[..., j : j + 1, j + 1:] / d[..., None, None]))
    X = torch.zeros_like(S)
    eye = torch.eye(M, dtype=S.dtype, device=S.device)
    for i in range(M):
        if i == 0:
            contrib = torch.zeros_like(X[..., 0, :])
        else:
            contrib = seqsum([U[..., r, i, None] * X[..., r, :] for r in range(i)])
        X[..., i, :] = (eye[i] - contrib) / U[..., i, i, None]
    return X


_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def chol_inv(S: torch.Tensor) -> torch.Tensor:
    """K14: L^-1 of each SPD S [..., M, M] f32 (M <= 128). A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (or raises),
    one warp (M <= 32) or one block a matrix."""
    if S.device.type == "cpu":
        return chol_linv(S)
    M = S.shape[-1]
    if S.dim() < 2 or S.shape[-2] != M or not 1 <= M <= MAX_M:
        raise ValueError(f"K14: expected [..., M, M] with M <= {MAX_M}, got {tuple(S.shape)}")
    n = S[..., 0, 0].numel()
    _build.check_tensor(S, "S", torch.float32, S.shape)
    out = torch.empty_like(S)
    fn = _build.function(NAME, "k14_chol_inv", _ARGTYPES, reg_defines(M))
    err = fn(S.data_ptr(), out.data_ptr(), n, M, torch.cuda.current_stream(S.device).cuda_stream)
    _build.check(err, "K14 chol_inv")
    _build.launches[NAME] += 1
    return out


def bytes_and_flops(n: int, M: int) -> tuple[int, int]:
    """Least bytes (each S read once, each L^-1 written once) and float
    operations of one K14 call on n matrices: the factorisation (~M^3 / 3
    multiply-adds and M square roots and divisions) and the substitution
    (~M^3 / 6 multiply-adds on the lower triangle)."""
    return 2 * n * M * M * 4, n * (2 * M ** 3 // 3 + M ** 3 // 3 + 2 * M * M)
