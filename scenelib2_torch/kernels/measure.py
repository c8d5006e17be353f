"""K7 and the per-slot measurement-prediction chain it shares with K1.

K7 replaces the TPU kernel scenelib2_tpu/kernels/pallas_measure.py
(``pallas_measure_predict`` / ``_measure_kernel``) together with what the
JAX batch step does with its rows (lax.top_k of the score row, the visible
count, the gather of the selected rows): stage 2 of the batch step and of
the single stream's split route, from the predicted state x [B, D] and
P [B, D, D] read in place. ``measure_select`` launches it; its plain twin
``measure_select_plain`` is the composition the step ran before the kernel
took the selection in: the slot gathers of runtime/state.py
(``chain_inputs``), ``measure_predict_plain``, the visible count,
``stable_top_k`` and the gather. The CUDA kernel is csrc/measure.cu: one
CTA a lane, the chain's pieces (csrc/measure_chain.cuh) spread over warp
groups, the rank by pairwise comparison.

Bound on an H100 at 64 lanes x 16 slots: ~0.26 MB in and out and ~0.6
MFLOP, well under a microsecond; the launch and one slot's dependent chain
set the time.

The chain as plain tensor code is a port of the same file: the row layout
of the result (O_*, NOUT) and ``_measure_math`` (pallas_measure.py:85-227),
which predicts, for every feature slot at once, the image measurement h,
its Jacobians hx/hy, the measurement noise, the innovation covariance S_i,
its Cholesky 2x2 inverse, the visibility bit-flags and the selection score
(reference full_feature_model.cpp:67-195, feature_model.cpp:99-116,
camera.cpp:90-300). Slots are the last dimension of the lane tensors;
``measure_predict_plain`` (the JAX kernel's arguments) adds the step's
lanes as a leading dimension.

The kernels (K1, csrc/predict_measure.cu, and K7) evaluate the same chain
expression for expression: every sum is taken left to right, every
constant is rounded to f32 once, and divisions by a constant divide by a
tensor (PyTorch turns division by a Python scalar into a multiplication by
its reciprocal on CUDA, which rounds differently). With the kernels built
without FMA contraction, the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from scenelib2_torch.core.ekf import inv2x2_via_chol_parts
from scenelib2_torch.kernels import _build
from scenelib2_torch.core.quaternion import (
    dRq_times_a_by_dq_parts,
    quat_inverse_parts,
    quat_to_rotation_parts,
    seqsum,
)

# output row layout ([NOUT, MF])
O_H = 0              # hu, hv              rows 0..1
O_HX = 2             # hx7[2,7] row-major  rows 2..15
O_HY = 16            # hy[2,3] row-major   rows 16..21
O_RD = 22            # measurement noise variance (R = var*I2)
O_S = 23             # S00, S01, S11       rows 23..25
O_SINV = 26          # Sinv a, b, c        rows 26..28
O_VIS = 29           # visibility bit-flags (float)
O_ZZ = 30            # zeroed z (camera-frame depth)
O_SCORE = 31         # trace(S) where visible else -inf
NOUT = 32


@dataclass(frozen=True)
class MeasureConsts:
    """Static scalars of the chain, as Python floats (rounded to f32 where
    they meet tensors, as the JAX kernel's weak-typed constants are)."""
    fku: float
    fkv: float
    u0c: float
    v0c: float
    kd1: float
    sd0: float
    W: float
    H: float
    bnd: float
    max_len_ratio: float
    cos_max_angle: float

    @staticmethod
    def from_params(params) -> "MeasureConsts":
        return MeasureConsts(
            fku=params.cam_fku, fkv=params.cam_fkv, u0c=params.cam_u0,
            v0c=params.cam_v0, kd1=params.cam_kd1, sd0=params.cam_sd,
            W=float(params.cam_width), H=float(params.cam_height),
            bnd=float(params.image_search_boundary),
            max_len_ratio=float(params.max_length_ratio),
            cos_max_angle=float(math.cos(params.max_angle_difference)),
        )

    # derived constants, each rounded once (JAX evaluates these Python-side)
    @property
    def two_kd1(self) -> float:
        return 2.0 * self.kd1

    @property
    def neg_two_kd1(self) -> float:
        return -2.0 * self.kd1

    @property
    def maxd(self) -> float:
        return float((self.u0c * self.u0c + self.v0c * self.v0c) ** 0.5)

    @property
    def u_hi(self) -> float:
        return self.W - 1 - self.bnd

    @property
    def v_hi(self) -> float:
        return self.H - 1 - self.bnd

    @property
    def inv_len_ratio(self) -> float:
        return 1.0 / self.max_len_ratio


def measure_math(r, q4, pxx, y, xpo, pxy, pyy, act, c: MeasureConsts) -> torch.Tensor:
    """The per-slot chain on lane tensors.

    r (3), q4 (4) and pxx (7x7 nested) are 0-dim tensors; y (3), xpo (7),
    pxy ([7][3]), pyy ([3][3]) are [MF] lane tensors; act is the [MF] bool
    active-and-full mask. Returns the [NOUT, MF] result (O_* rows)."""
    lane = y[0]

    def k(v):  # a constant divided by (or dividing) a tensor
        return torch.tensor(v, dtype=lane.dtype, device=lane.device)

    # qRW = conj(q) / |q|^2 (Eigen inverse; q is near-unit, not unit)
    qRW = quat_inverse_parts(q4)
    RRW = quat_to_rotation_parts(qRW)
    ymr = [y[j] - r[j] for j in range(3)]
    zed = [seqsum([RRW[i][j] * ymr[j] for j in range(3)]) for i in range(3)]

    # project (camera.cpp:90-114)
    invz = 1.0 / zed[2]
    ucx = -c.fku * zed[0] * invz
    ucy = -c.fkv * zed[1] * invz
    rad2 = ucx * ucx + ucy * ucy
    dist = 1.0 + c.two_kd1 * rad2
    d12 = torch.sqrt(dist)
    hu = ucx / d12 + c.u0c
    hv = ucy / d12 + c.v0c

    # projection Jacobian (camera.cpp:183-215)
    d32 = d12 * dist
    cdi = k(c.neg_two_kd1) / d32
    A00 = ucx * ucx * cdi + 1.0 / d12
    A01 = ucx * ucy * cdi
    A11 = ucy * ucy * cdi + 1.0 / d12
    fkuz = c.fku * invz
    fkvz = c.fkv * invz
    du = [[-fkuz, 0.0, fkuz * zed[0] * invz], [0.0, -fkvz, fkvz * zed[1] * invz]]
    dh = [
        [A00 * du[0][kk] + A01 * du[1][kk] for kk in range(3)],
        [A01 * du[0][kk] + A11 * du[1][kk] for kk in range(3)],
    ]

    # dzeroed/dxp: cols 0:3 = -RRW, cols 3:7 = dRq(qRW, ymr) @ diag(1,-1,-1,-1)
    G = dRq_times_a_by_dq_parts(qRW, ymr)
    hx = [[None] * 7 for _ in range(2)]
    for i in range(2):
        for a in range(3):
            hx[i][a] = -seqsum([dh[i][kk] * RRW[kk][a] for kk in range(3)])
        for cc in range(4):
            s = seqsum([dh[i][kk] * G[kk][cc] for kk in range(3)])
            hx[i][3 + cc] = s if cc == 0 else -s
    hy = [[seqsum([dh[i][kk] * RRW[kk][j] for kk in range(3)]) for j in range(3)]
          for i in range(2)]

    # measurement noise (camera.cpp:282-300)
    du_c = hu - c.u0c
    dv_c = hv - c.v0c
    dc = torch.sqrt(du_c * du_c + dv_c * dv_c)
    sd = c.sd0 * (1.0 + dc / k(c.maxd))
    Rd = sd * sd

    # S_i = Hx Pxx Hx' + Hx Pxy Hy' + (.)' + Hy Pyy Hy' + R
    S = [[None, None], [None, None]]
    for b in range(2):
        v_b = [seqsum([pxx[i][j] * hx[b][j] for j in range(7)]) for i in range(7)]
        w_b = [seqsum([pxy[a][j] * hy[b][j] for j in range(3)]) for a in range(7)]
        p_b = [seqsum([pyy[i][j] * hy[b][j] for j in range(3)]) for i in range(3)]
        for a in range(b, 2):
            Sab = seqsum([hx[a][i] * v_b[i] for i in range(7)])
            Tab = seqsum([hx[a][i] * w_b[i] for i in range(7)])
            Tba = seqsum([hy[a][j] * seqsum([pxy[i][j] * hx[b][i] for i in range(7)])
                        for j in range(3)])
            Pab = seqsum([hy[a][i] * p_b[i] for i in range(3)])
            S[a][b] = Sab + Tab + Tba + Pab
    S00 = S[0][0] + Rd
    S01 = S[1][0]
    S11 = S[1][1] + Rd

    # 2x2 inverse via Cholesky (monoslam.cpp:371-374 order)
    sinv_a, sinv_b, sinv_c = inv2x2_via_chol_parts(S00, S01, S11)

    # visibility (full_feature_model.cpp:103-170)
    fl_lr = (hu < c.bnd) | (hu > c.u_hi)
    fl_ud = (hv < c.bnd) | (hv > c.v_hi)
    fl_behind = zed[2] <= 0.0
    RWR = quat_to_rotation_parts(q4)
    hLW = [seqsum([RWR[i][kk] * zed[kk] for kk in range(3)]) for i in range(3)]
    ro = xpo[0:3]
    qo = xpo[3:7]
    RRWo = quat_to_rotation_parts(quat_inverse_parts(qo))
    ymro = [y[j] - ro[j] for j in range(3)]
    zo = [seqsum([RRWo[i][j] * ymro[j] for j in range(3)]) for i in range(3)]
    RWRo = quat_to_rotation_parts(qo)
    hLWo = [seqsum([RWRo[i][kk] * zo[kk] for kk in range(3)]) for i in range(3)]
    mod = torch.sqrt(seqsum([hLW[i] * hLW[i] for i in range(3)]))
    modo = torch.sqrt(seqsum([hLWo[i] * hLWo[i] for i in range(3)]))
    lr = mod / modo
    fl_dist = (lr > c.max_len_ratio) | (lr < c.inv_len_ratio)
    dotp = seqsum([hLW[i] * hLWo[i] for i in range(3)])
    cosang = torch.clamp(dotp / (mod * modo), -1.0, 1.0)
    # angle > max_angle  <=>  cos(angle) < cos(max_angle) on [0, pi]
    fl_ang = cosang < c.cos_max_angle

    def fsel(cond, v):
        return cond.to(lane.dtype) * v

    vis = seqsum([fsel(fl_lr, 1.0), fsel(fl_ud, 2.0), fsel(fl_dist, 4.0),
                fsel(fl_ang, 8.0), fsel(fl_behind, 16.0)])
    visible = act & (vis == 0.0)
    score = torch.where(visible, S00 + S11, torch.full_like(S00, -math.inf))

    rows = [hu, hv]
    rows += [hx[i][a] for i in range(2) for a in range(7)]
    rows += [hy[i][j] for i in range(2) for j in range(3)]
    rows += [Rd, S00, S01, S11, sinv_a, sinv_b, sinv_c, vis, zed[2], score]
    return torch.stack([t.expand_as(lane) for t in rows])


NAME = "measure"


def stable_top_k(score: torch.Tensor, k: int):
    """(values [..., k], indices [..., k] int32) of the k largest entries of
    score [..., n] in lax.top_k's order: descending, equal scores lowest
    index first, and a NaN ahead of every number (XLA's total order). By
    pairwise comparison, so the order is the same on every device;
    torch.topk promises no order among equal scores."""
    n = score.shape[-1]
    idx = torch.arange(n, device=score.device)
    a = score[..., :, None]                       # the candidate that beats
    b = score[..., None, :]                       # the one that is beaten
    a_nan, b_nan = torch.isnan(a), torch.isnan(b)
    same = (a == b) | (a_nan & b_nan)
    beats = (a > b) | (a_nan & ~b_nan) | (same & (idx[:, None] < idx[None, :]))
    rank = beats.sum(dim=-2)                      # [..., n]: how many beat entry j
    onehot = rank[..., :, None] == torch.arange(k, device=score.device)      # [..., n, k]
    top_idx = (onehot * idx[:, None]).sum(dim=-2)
    return torch.gather(score, -1, top_idx), top_idx.to(torch.int32)


def measure_predict_plain(xp, pxx7, ys3, xp_org, pxy, pyy, act_full, c: MeasureConsts):
    """K7's chain on the JAX kernel's arguments (pallas_measure_predict's,
    lanes leading; measure_select_plain runs it on chain_inputs, and the
    JAX tests hold it against the TPU kernel). xp [B, 7], pxx7 [B, 7, 7],
    ys3 [B, MF, 3], xp_org [B, MF, 7], pxy [B, MF, 7, 3], pyy [B, MF, 3, 3]
    f32 and act_full [B, MF] bool (active and fully initialised). Returns
    the [B, NOUT, MF] rows (O_*). Lanes are a leading dimension of every
    lane tensor of measure_math, so each lane runs the unbatched
    arithmetic."""
    r = [xp[:, i, None] for i in range(3)]
    q4 = [xp[:, 3 + i, None] for i in range(4)]
    pxx = [[pxx7[:, i, j, None] for j in range(7)] for i in range(7)]
    y = [ys3[..., j] for j in range(3)]
    xpo = [xp_org[..., j] for j in range(7)]
    pxy_l = [[pxy[..., a, j] for j in range(3)] for a in range(7)]
    pyy_l = [[pyy[..., i, j] for j in range(3)] for i in range(3)]
    return measure_math(r, q4, pxx, y, xpo, pxy_l, pyy_l, act_full, c).movedim(0, 1)


class Selected(NamedTuple):
    """K7's results: the step's stage-2 selection, lanes leading."""
    top_idx: torch.Tensor      # [B, NSEL] i32, stable_top_k's order
    top_score: torch.Tensor    # [B, NSEL] (-inf where not visible; NaN kept)
    n_visible: torch.Tensor    # [B] i32
    h_sel: torch.Tensor        # [B, NSEL, 2]
    hx_sel: torch.Tensor       # [B, NSEL, 2, 7]
    hy_sel: torch.Tensor       # [B, NSEL, 2, 3]
    Rd_sel: torch.Tensor       # [B, NSEL]
    S_sel: torch.Tensor        # [B, NSEL, 2, 2]
    sinv_abc: torch.Tensor     # [B, NSEL, 3]
    rows: torch.Tensor | None  # [B, NOUT, MF] every slot's chain (rows=True), else None


def chain_inputs(x, P, xp_org, act_full):
    """measure_predict_plain's arguments (the JAX kernel's) from the
    step's x [B, D], P [B, D, D], xp_org [B, MF, 7] and the active-and-full
    mask [B, MF]: slot s's block starts at 13 + 6 s; its point is y's first
    3 entries, pxy rows 0..6 of P by its first 3 columns, pyy the 3 x 3
    corner of its diagonal block (the slot gathers of runtime/state.py)."""
    B, MF = act_full.shape
    slot_x = x[:, 13:].reshape(B, MF, 6)
    pxy = P[:, :7, 13:].reshape(B, 7, MF, 6).transpose(1, 2)                       # [B, MF, 7, 6]
    pyy = torch.diagonal(P[:, 13:, 13:].reshape(B, MF, 6, MF, 6), dim1=1, dim2=3).movedim(-1, 1)
    return (x[:, :7], P[:, :7, :7], slot_x[..., :3], xp_org, pxy[..., :3], pyy[..., :3, :3], act_full)


def measure_select_plain(x, P, xp_org, active, full, nsel: int, c: MeasureConsts,
                         rows: bool = False) -> Selected:
    """Plain PyTorch K7: the chain on every slot, then the visible count,
    the stable top-nsel of the score row and the selected rows in the
    layouts the split stages read."""
    act_full = active & full
    meas = measure_predict_plain(*chain_inputs(x, P, xp_org, act_full), c)
    Bn = meas.shape[0]
    n_visible = (act_full & (meas[:, O_VIS] == 0.0)).sum(-1).to(torch.int32)
    top_score, top_idx = stable_top_k(meas[:, O_SCORE], nsel)
    top64 = top_idx.long()
    sel = torch.gather(meas, 2, top64[:, None, :].expand(Bn, meas.shape[1], nsel))   # [B, NOUT, NSEL]
    return Selected(
        top_idx=top_idx, top_score=top_score, n_visible=n_visible,
        h_sel=sel[:, O_H : O_H + 2].mT,
        hx_sel=sel[:, O_HX : O_HX + 14].mT.reshape(Bn, nsel, 2, 7),
        hy_sel=sel[:, O_HY : O_HY + 6].mT.reshape(Bn, nsel, 2, 3),
        Rd_sel=sel[:, O_RD],
        S_sel=torch.stack([sel[:, O_S], sel[:, O_S + 1], sel[:, O_S + 1], sel[:, O_S + 2]],
                          dim=-1).reshape(Bn, nsel, 2, 2),
        sinv_abc=sel[:, O_SINV : O_SINV + 3].mT.contiguous(),
        rows=meas if rows else None)


class _K7Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float) for n in (
        "fku", "fkv", "u0c", "v0c", "two_kd1", "neg_two_kd1", "sd0", "maxd",
        "bnd", "u_hi", "v_hi", "max_len_ratio", "inv_len_ratio", "cos_max_angle",
    )]


# tensor pointers (5 inputs, 3 outputs), B, D, MF, NSEL, the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.POINTER(_K7Params), ctypes.c_void_p]
MAX_MF = 128   # csrc/measure.cu K7_MAX_MF, as JAX's K7 asserts (pallas_measure.py:283)
# the float output of csrc/measure.cu (SEL_*): each quantity's floats a
# selected slot, in order
SEL_LAYOUT = (("top_score", 1), ("h_sel", 2), ("hx_sel", 14), ("hy_sel", 6), ("Rd_sel", 1),
              ("S_sel", 4), ("sinv_abc", 3))
SEL_SHAPES = {"top_score": (), "h_sel": (2,), "hx_sel": (2, 7), "hy_sel": (2, 3), "Rd_sel": (),
              "S_sel": (2, 2), "sinv_abc": (3,)}


def measure_select(x, P, xp_org, active, full, nsel: int, c: MeasureConsts,
                   rows: bool = False) -> Selected:
    """K7. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same results as measure_select_plain; rows=True
    also writes every slot's chain ([B, NOUT, MF])."""
    if x.device.type == "cpu":
        return measure_select_plain(x, P, xp_org, active, full, nsel, c, rows)
    B, MF = active.shape
    D = x.shape[-1]
    if not (1 <= MF <= MAX_MF and 1 <= nsel <= MF and D >= 13 + 6 * MF):
        raise ValueError(f"K7: unsupported shapes D={D} MF={MF} nsel={nsel}")
    f32 = torch.float32
    for t, name, dty, shp in zip(
        (x, P, xp_org, active, full), ("x", "P", "xp_org", "active", "full"),
        (f32, f32, f32, torch.bool, torch.bool), ((B, D), (B, D, D), (B, MF, 7), (B, MF), (B, MF)),
    ):
        _build.check_tensor(t, name, dty, shp)
    dev = x.device
    BN = B * nsel
    fout = torch.empty(sum(n for _k, n in SEL_LAYOUT) * BN, dtype=f32, device=dev)
    iout = torch.empty(BN + B, dtype=torch.int32, device=dev)
    meas = torch.empty((B, NOUT, MF), dtype=f32, device=dev) if rows else None
    prm = _K7Params(
        fku=c.fku, fkv=c.fkv, u0c=c.u0c, v0c=c.v0c, two_kd1=c.two_kd1,
        neg_two_kd1=c.neg_two_kd1, sd0=c.sd0, maxd=c.maxd, bnd=c.bnd, u_hi=c.u_hi,
        v_hi=c.v_hi, max_len_ratio=c.max_len_ratio, inv_len_ratio=c.inv_len_ratio,
        cos_max_angle=c.cos_max_angle,
    )
    fn = _build.function(NAME, "k7_measure_select", _ARGTYPES)
    err = fn(x.data_ptr(), P.data_ptr(), xp_org.data_ptr(), active.data_ptr(), full.data_ptr(),
             fout.data_ptr(), iout.data_ptr(), 0 if meas is None else meas.data_ptr(), B, D, MF, nsel,
             ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K7 measure")
    _build.launches[NAME] += 1
    out, at = {}, 0
    for k, n in SEL_LAYOUT:
        out[k] = fout[at : at + n * BN].view(B, nsel, *SEL_SHAPES[k])
        at += n * BN
    return Selected(top_idx=iout[:BN].view(B, nsel), n_visible=iout[BN:], rows=meas, **out)


def bytes_and_flops(B: int, D: int, MF: int, nsel: int) -> tuple[int, int]:
    """Least bytes (what the chain reads of x, P and xp_org, the two masks,
    the selected rows and counts written once) and operations (~600 a slot
    for the chain, MF^2 comparisons a lane for the rank) of one K7 call."""
    per_lane_in = (7 + 49) * 4 + MF * ((3 + 21 + 9 + 7) * 4 + 2)
    per_lane_out = nsel * (sum(n for _k, n in SEL_LAYOUT) + 1) * 4 + 4
    return B * (per_lane_in + per_lane_out), B * (600 * MF + MF * MF)
