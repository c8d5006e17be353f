"""K1: fused EKF predict + per-slot measurement prediction + top-NSEL selection.

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_predict_measure.py
(``pallas_predict_measure`` / ``_predict_measure_kernel``, which shares
``pallas_measure.py::_measure_math``). Stages 1 and 2 of the step
(reference kalman.cpp:50-69 then monoslam.cpp:187-308):

  predict — x' = f(x) and P' = F~ P F~' + Q~ with F~ = blockdiag(F, I):
    only the camera rows and columns change (Pxx' = F Pxx F' + Q, symmetrized
    as 0.5*(A + A'); Pxy' = F Pxy and Pyx' its transpose); the feature block
    of P passes through bit-unchanged.
  measure — the per-slot chain of kernels/measure.py on the predicted state.
  select  — stable descending rank of the scores (ties to the lowest lane,
    as lax.top_k), non-finite scores clamped to exactly -3e38 first; the
    selected [NOUT, NSEL] column block with non-finite entries zeroed; the
    visible count; the first MAXP partial slots, lowest lane first.

Bound on an H100 (bytes_and_flops): P read once and P' written once, 8 D^2
bytes (0.095 MB at D = 109, 1.1 MB at D = 373), a fraction of a microsecond;
the operations are fewer still. Design (csrc/predict_measure.cu): a grid of
1 + copy_ctas(D, SMs) CTAs of 256 threads. CTA 0 runs the critical path
(F and Q with the entries split over threads, the camera block of F P and
the columns each slot reads, A, Pc, x', one thread per slot for the
measurement chain, the rank by pairwise comparison, n_visible and the
partial slots by ballots); the other CTAs write the rest of P' in 16-byte
units of the flat index, each building F itself, so each element of P' is
written once, by one CTA, with no CTA waiting for another.
"""

from __future__ import annotations

import ctypes

import torch

from scenelib2_torch.core.quaternion import (
    dq3_by_dq1_parts,
    dq3_by_dq2_parts,
    dqomegadt_by_domega_parts,
    quat_from_angular_velocity_parts,
    quat_mul_parts,
    seqsum,
)
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.measure import NOUT, O_SCORE, O_VIS, MeasureConsts, measure_math

CAM_DIM = 13
SLOT_DIM = 6
NEG_SENTINEL = -3e38
NAME = "predict_measure"


def _predict_scalars(x, dt: float, sd_a: float, sd_alpha: float):
    """fv, F (13x13) and Q (13x13) of the motion model (motion_model.cpp:
    84-217, u = 0), scalar by scalar in the kernel's operation order, from
    the component forms of core/quaternion.py."""
    dev, dty = x.device, x.dtype

    def k(v):
        return torch.tensor(v, dtype=dty, device=dev)

    one, zero = k(1.0), k(0.0)
    s = [x[i] for i in range(CAM_DIM)]
    r, q, v, w = s[0:3], s[3:7], s[7:10], s[10:13]
    rn = [r[i] + v[i] * dt for i in range(3)]
    qt = quat_from_angular_velocity_parts([wi * dt for wi in w])
    qn = quat_mul_parts(q, qt)
    dOm = dqomegadt_by_domega_parts(w, dt)
    D1 = dq3_by_dq1_parts(q)
    M = [[seqsum([D1[i][kk] * dOm[kk][j] for kk in range(4)]) for j in range(3)]
         for i in range(4)]
    qb = dq3_by_dq2_parts(qt)

    F = [[one if i == j else zero for j in range(CAM_DIM)] for i in range(CAM_DIM)]
    for i in range(3):
        F[i][7 + i] = k(dt)
    for i in range(4):
        for j in range(4):
            F[3 + i][3 + j] = qb[i][j]
        for j in range(3):
            F[3 + i][10 + j] = M[i][j]

    # Q = G Pnn G' (motion_model.cpp:148-217), G [13, 6]
    lin_var = sd_a * sd_a * dt * dt
    ang_var = sd_alpha * sd_alpha * dt * dt
    Gm = [[zero] * 6 for _ in range(CAM_DIM)]
    for i in range(3):
        Gm[i][i] = k(dt)
        Gm[7 + i][i] = one
        Gm[10 + i][3 + i] = one
    for i in range(4):
        for j in range(3):
            Gm[3 + i][3 + j] = M[i][j]
    Gt = torch.stack([torch.stack(row) for row in Gm])               # [13, 6]
    pnn = torch.tensor([lin_var] * 3 + [ang_var] * 3, dtype=dty, device=dev)
    Gp = Gt * pnn[None, :]
    Q = Gp[:, 0:1] * Gt[:, 0][None, :]
    for kk in range(1, 6):
        Q = Q + Gp[:, kk : kk + 1] * Gt[:, kk][None, :]
    Ft = torch.stack([torch.stack(row) for row in F])
    return rn, qn, Ft, Q


def predict_measure_plain(x, P, xp_org, act_full, act_part, *, nsel: int, maxp: int,
                          dt: float, sd_a: float, sd_alpha: float, consts: MeasureConsts):
    """Plain PyTorch K1. Returns (meas [NOUT, MF], sel [NOUT, nsel],
    x' [D], P' [D,D], top_idx [nsel] i32, top_score [nsel], n_visible [] i32,
    pidx [maxp] i32, pmask [maxp] bool)."""
    D = x.shape[0]
    MF = xp_org.shape[0]
    rn, qn, F, Q = _predict_scalars(x, dt, sd_a, sd_alpha)

    # top = F P[:13, :] (k ascending), A = top[:, :13] F' + Q
    top = F[:, 0:1] * P[0:1, :]
    for kk in range(1, CAM_DIM):
        top = top + F[:, kk : kk + 1] * P[kk : kk + 1, :]
    A = top[:, 0:1] * F[:, 0][None, :]
    for kk in range(1, CAM_DIM):
        A = A + top[:, kk : kk + 1] * F[:, kk][None, :]
    A = A + Q
    Pc = 0.5 * (A + A.T)
    Po = P.clone()
    Po[:CAM_DIM, :] = top
    Po[:, :CAM_DIM] = top.T
    Po[:CAM_DIM, :CAM_DIM] = Pc
    xo = x.clone()
    xo[0:3] = torch.stack(rn)
    xo[3:7] = torch.stack(qn)

    lanes = torch.arange(MF, device=x.device)
    off = CAM_DIM + SLOT_DIM * lanes
    y = [x[off + j] for j in range(3)]
    pxy = [[top[a, off + j] for j in range(3)] for a in range(7)]
    pyy = [[P[off + i, off + j] for j in range(3)] for i in range(3)]
    pxx = [[Pc[i, j] for j in range(7)] for i in range(7)]
    xpo = [xp_org[:, j] for j in range(7)]
    meas = measure_math(rn, qn, pxx, y, xpo, pxy, pyy, act_full, consts)

    score = meas[O_SCORE]
    work = torch.where(torch.isfinite(score), score, torch.full_like(score, NEG_SENTINEL))
    a_ = work[:, None]                                   # [k2, k] = s[k2]
    b_ = work[None, :]                                   # [k2, k] = s[k]
    beats = (a_ > b_) | ((a_ == b_) & (lanes[:, None] < lanes[None, :]))
    rank = beats.sum(dim=0)                              # [MF]
    onehot = rank[:, None] == torch.arange(nsel, device=x.device)[None, :]   # [MF, nsel]
    top_idx = (onehot * lanes[:, None]).sum(dim=0).to(torch.int32)
    top_score = work[top_idx.long()]
    meas_dot = torch.where(torch.isfinite(meas), meas, torch.zeros_like(meas))
    sel = meas_dot[:, top_idx.long()]
    n_visible = (act_full & (meas[O_VIS] == 0.0)).sum().to(torch.int32)

    # the first maxp partial slots, lowest lane first (then the lowest
    # non-partial lanes, unmasked)
    key = torch.where(act_part, lanes, lanes + MF)
    pidx = torch.argsort(key)[:maxp].to(torch.int32)
    pmask = act_part[pidx.long()]
    return meas, sel, xo, Po, top_idx, top_score, n_visible, pidx, pmask


# float4 units of P' a copy CTA's thread takes (scripts/ab_predict_st_kernels.py
# --grid, PERF.md section 6)
UNITS_PER_THREAD = 2
THREADS = 256    # csrc/predict_measure.cu K1_THREADS


def copy_ctas(D: int, n_sms: int) -> int:
    """The CTAs that write P' outside the camera block: enough for
    UNITS_PER_THREAD 16-byte units a thread, at most one wave beside CTA 0
    (D = 109: 6 CTAs, D = 373: 68 on 132 SMs)."""
    units = (D * D + 3) // 4
    per_cta = THREADS * UNITS_PER_THREAD
    return max(1, min(n_sms - 1, (units + per_cta - 1) // per_cta))


class _K1Params(ctypes.Structure):
    _fields_ = [(n, ctypes.c_float) for n in (
        "dt", "half_dt", "lin_var", "ang_var",
        "fku", "fkv", "u0c", "v0c", "two_kd1", "neg_two_kd1", "sd0", "maxd",
        "bnd", "u_hi", "v_hi", "max_len_ratio", "inv_len_ratio", "cos_max_angle",
    )]


# tensor pointers, ints (D, MF, nsel, maxp, the copy CTAs), the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 5 + [ctypes.POINTER(_K1Params), ctypes.c_void_p]


def predict_measure(x, P, xp_org, act_full, act_part, *, nsel: int, maxp: int,
                    dt: float, sd_a: float, sd_alpha: float, consts: MeasureConsts):
    """K1. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as predict_measure_plain."""
    kw = dict(nsel=nsel, maxp=maxp, dt=dt, sd_a=sd_a, sd_alpha=sd_alpha, consts=consts)
    if x.device.type == "cpu":
        return predict_measure_plain(x, P, xp_org, act_full, act_part, **kw)
    D = x.shape[0]
    MF = xp_org.shape[0]
    if not (D == CAM_DIM + SLOT_DIM * MF and MF <= 128 and nsel <= MF and 1 <= maxp <= MF):
        raise ValueError(f"K1: unsupported shapes D={D} MF={MF} nsel={nsel} maxp={maxp}")
    f32 = torch.float32
    _build.check_tensor(x, "x", f32, (D,))
    _build.check_tensor(P, "P", f32, (D, D))
    _build.check_tensor(xp_org, "xp_org", f32, (MF, 7))
    _build.check_tensor(act_full, "act_full", torch.bool, (MF,))
    _build.check_tensor(act_part, "act_part", torch.bool, (MF,))
    dev = x.device
    meas = torch.empty((NOUT, MF), dtype=f32, device=dev)
    sel = torch.empty((NOUT, nsel), dtype=f32, device=dev)
    xo = torch.empty_like(x)
    Po = torch.empty_like(P)
    top_idx = torch.empty(nsel, dtype=torch.int32, device=dev)
    top_score = torch.empty(nsel, dtype=f32, device=dev)
    n_visible = torch.empty((), dtype=torch.int32, device=dev)
    pidx = torch.empty(maxp, dtype=torch.int32, device=dev)
    pmask = torch.empty(maxp, dtype=torch.bool, device=dev)
    c = consts
    prm = _K1Params(
        dt=dt, half_dt=dt / 2.0, lin_var=sd_a * sd_a * dt * dt,
        ang_var=sd_alpha * sd_alpha * dt * dt,
        fku=c.fku, fkv=c.fkv, u0c=c.u0c, v0c=c.v0c, two_kd1=c.two_kd1,
        neg_two_kd1=c.neg_two_kd1, sd0=c.sd0, maxd=c.maxd, bnd=c.bnd,
        u_hi=c.u_hi, v_hi=c.v_hi, max_len_ratio=c.max_len_ratio,
        inv_len_ratio=c.inv_len_ratio, cos_max_angle=c.cos_max_angle,
    )
    fn = _build.function(NAME, "k1_predict_measure", _ARGTYPES)
    err = fn(
        x.data_ptr(), P.data_ptr(), xp_org.data_ptr(), act_full.data_ptr(),
        act_part.data_ptr(), meas.data_ptr(), sel.data_ptr(), xo.data_ptr(),
        Po.data_ptr(), top_idx.data_ptr(), top_score.data_ptr(),
        n_visible.data_ptr(), pidx.data_ptr(), pmask.data_ptr(),
        D, MF, nsel, maxp,
        copy_ctas(D, _build.n_sms(dev)),
        ctypes.byref(prm),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "K1 predict_measure")
    _build.launches[NAME] += 1
    return meas, sel, xo, Po, top_idx, top_score, n_visible, pidx, pmask


def bytes_and_flops(D: int, MF: int, nsel: int) -> tuple[int, int]:
    """Least bytes moved (inputs read once, outputs written once) and float
    operations of one K1 call, for the roofline bound."""
    f = 4
    bytes_in = D * f + D * D * f + MF * 7 * f + 2 * MF
    bytes_out = NOUT * MF * f + NOUT * nsel * f + D * f + D * D * f + nsel * 8 + 4 + 8
    # F P on 13 camera rows (13 mul+add over D columns), A = top F' + Q,
    # and ~600 scalar operations per slot in the measurement chain
    flops = 2 * CAM_DIM * CAM_DIM * D + 2 * CAM_DIM ** 3 + 600 * MF + MF * MF
    return bytes_in + bytes_out, flops

