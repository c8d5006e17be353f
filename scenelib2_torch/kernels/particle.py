"""K10 and the per-particle measurement prediction of a partial (ray)
feature that it shares with K4.

K10 replaces the TPU kernel scenelib2_tpu/kernels/pallas_particle.py
(``pallas_particle_predict_fused`` / ``_predict_geom_kernel``): stage 8 of
the batch step, the chain below for every (lane, partial slot) from the
slot's blocks of the state. It writes the [8, lanes] prediction rows
(ROW_*) that K11 reads, lanes = max(128, NP rounded up to 128) as the TPU
wrapper pads them (bayes.padded_lanes; 256 at hires' 200 particles), the
lanes beyond NP computed at lambda = 1. The CUDA kernel is
csrc/particle_predict.cu: one block per (lane, slot), the slot's geometry
prologue spread over the block, its threads striding over the particle
lanes, over csrc/particle_chain.cuh, the same device code that K4
(csrc/search_bayes.cu) runs in its prologue, so K10's rows equal the rows
K4 produces for the same slot.

K10b (particle_predict_kform) replaces the TPU kernel's K-form-input
sibling, pallas_particle.py::pallas_particle_predict (pallas_call at
pallas_particle.py:197), which only the JAX package's tests call: the same
tail from the ray geometry and K0 / Ksym / K2 given as inputs. Its CUDA
kernel (csrc/particle_kform.cu) runs particle_chain.cuh's tail only, so on
the geometry that K10's prologue computes it writes K10's rows.

Bound on an H100 at 64 lanes x 1 slot x 100 particles: ~0.3 MB in and out
and ~0.7 MFLOP, well under a microsecond; the launch dominates (K10b: a
slot's 33 geometry values in, five rows of NP out, ~90 operations a lane).

The chain as plain tensor code:

Port of scenelib2_tpu/kernels/pallas_particle.py: the row layout of the
result (ROW_*), the packed operand rows (the shared camera row and the slot
row), ``_geometry_prologue`` (pallas_particle.py:293-357, with ``_dot_row``,
``_mat_mul_t`` and ``_drq_dqbar``) and ``_particle_tail`` (:42-124). For every
depth hypothesis lambda of a ray it predicts the image point
hpi = project(zeroedri + lambda zeroedhhat), the innovation covariance in
the factored K-form S = A (K0 + lambda Ksym + lambda^2 K2) A' + R, its
Cholesky inverse and determinant, and the 3-sigma search half-extents
(reference part_feature_model.cpp:231-265, feature_init_info.cpp:57-65).

Every sum runs in the TPU kernel's order: the prologue's dot rows skip the
literal zeros of N1/N2 and sum the other terms left to right; constant
divisors are 0-dim tensors (a division by a Python scalar becomes a
multiply by its reciprocal on CUDA). Every function takes leading (lane,
slot) dimensions: the rows lie in the LAST dimension.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from scenelib2_torch.core.quaternion import seqsum
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.bayes import padded_lanes

NAME = "particle_predict"
NAME_KFORM = "particle_kform"   # K10b: its own library (csrc/particle_kform.cu) and launch count

ROW_HU, ROW_HV, ROW_S00, ROW_S01, ROW_S11, ROW_DET, ROW_HW, ROW_HH = range(8)

# shared row: xp[7] + Pxx7 row-major [49]; slot row: y6[6] + pxy7 row-major
# [7][6] (pxy7[i][j] = P[slot dim j, camera dim i]) + pyy row-major [36]
SH_XP, SH_PXX, NSHARED = 0, 7, 56
SL_Y, SL_PXY, SL_PYY, NSLOT = 0, 6, 48, 84

# the non-literal-zero columns of N1 = [-R | B1 | R | 0] and N2 = [0 | B2 | 0 | R]
NZ1 = tuple(range(10))
NZ2 = (3, 4, 5, 6, 10, 11, 12)


@dataclass(frozen=True)
class ParticleConsts:
    fku: float
    fkv: float
    u0c: float
    v0c: float
    kd1: float
    sd0: float
    maxdist: float   # |centre| in f32, as the TPU wrapper computes it
    no_sigma: float

    @staticmethod
    def from_params(p) -> "ParticleConsts":
        return ParticleConsts.of(p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1, p.cam_sd,
                                 p.no_sigma)

    @staticmethod
    def of(fku, fkv, u0c, v0c, kd1, sd0, no_sigma) -> "ParticleConsts":
        u0, v0 = np.float32(u0c), np.float32(v0c)
        return ParticleConsts(
            fku=float(fku), fkv=float(fkv), u0c=float(u0c), v0c=float(v0c), kd1=float(kd1),
            sd0=float(sd0), maxdist=float(np.sqrt(u0 * u0 + v0 * v0)), no_sigma=float(no_sigma),
        )


def pack_rows(x: torch.Tensor, P: torch.Tensor, slot: torch.Tensor):
    """The shared camera row [56] and the slot row [84] of one partial slot
    (runtime/step.py:986-996 of the JAX package): the slot's blocks are read
    from its ROWS of P. slot is a [] integer tensor (no host read)."""
    idx6 = 13 + 6 * slot.to(torch.int64) + torch.arange(6, device=x.device)
    rows6 = P[idx6]                                                    # [6, D]
    shared = torch.cat([x[:7], P[:7, :7].reshape(49)])
    slot_row = torch.cat([x[idx6], rows6[:, :7].T.reshape(42), rows6[:, idx6].reshape(36)])
    return shared, slot_row


def _drq_dqbar(qw, qx, qy, qz, a):
    """dRq_times_a_by_dq(q, a) @ dqbar_by_dq as [3][4] parts."""
    a0, a1, a2 = a
    col0 = [2.0 * (qw * a0 - qz * a1 + qy * a2), 2.0 * (qz * a0 + qw * a1 - qx * a2),
            2.0 * (-qy * a0 + qx * a1 + qw * a2)]
    col1 = [2.0 * (qx * a0 + qy * a1 + qz * a2), 2.0 * (qy * a0 - qx * a1 - qw * a2),
            2.0 * (qz * a0 + qw * a1 - qx * a2)]
    col2 = [2.0 * (-qy * a0 + qx * a1 + qw * a2), 2.0 * (qx * a0 + qy * a1 + qz * a2),
            2.0 * (-qw * a0 + qz * a1 - qy * a2)]
    col3 = [2.0 * (-qz * a0 - qw * a1 + qx * a2), 2.0 * (qw * a0 - qz * a1 + qy * a2),
            2.0 * (qx * a0 + qy * a1 + qz * a2)]
    return [[col0[i], -col1[i], -col2[i], -col3[i]] for i in range(3)]


def geometry_prologue(shared: torch.Tensor, slot_row: torch.Tensor):
    """The lambda-independent slot geometry: (zr [..., 3], zh [..., 3],
    K0 [..., 3, 3], Ksym [..., 3, 3], K2 [..., 3, 3]) tensors
    (runtime/step.py slot_geom + core/models.part_zeroedyi of the JAX
    package). shared [..., 56] and slot_row [..., 84] carry the same leading
    dimensions (shared is expanded to slot_row's)."""
    lead = slot_row.shape[:-1]
    shared = shared.expand(*lead, NSHARED)
    r = [shared[..., SH_XP + i] for i in range(3)]
    w, x, y, z = (shared[..., SH_XP + 3 + i] for i in range(4))
    Pxx7 = shared[..., SH_PXX : SH_PXX + 49].reshape(*lead, 7, 7)
    ri = [slot_row[..., SL_Y + i] for i in range(3)]
    hh = [slot_row[..., SL_Y + 3 + i] for i in range(3)]
    P12 = slot_row[..., SL_PXY : SL_PXY + 42].reshape(*lead, 7, 6)
    P22 = slot_row[..., SL_PYY : SL_PYY + 36].reshape(*lead, 6, 6)

    # qRW = conj(q) * (1 / |q|^2), then Eigen's unit-quaternion rotation
    inv_n2 = 1.0 / (w * w + x * x + y * y + z * z)
    qw, qx, qy, qz = w * inv_n2, -x * inv_n2, -y * inv_n2, -z * inv_n2
    wx, wy, wz = 2.0 * qw * qx, 2.0 * qw * qy, 2.0 * qw * qz
    xx, xy, xz = 2.0 * qx * qx, 2.0 * qx * qy, 2.0 * qx * qz
    yy, yz, zz = 2.0 * qy * qy, 2.0 * qy * qz, 2.0 * qz * qz
    R = [[1.0 - (yy + zz), xy - wz, xz + wy],
         [xy + wz, 1.0 - (xx + zz), yz - wx],
         [xz - wy, yz + wx, 1.0 - (xx + yy)]]
    ym = [ri[i] - r[i] for i in range(3)]
    zr = torch.stack([seqsum([R[i][k] * ym[k] for k in range(3)]) for i in range(3)], dim=-1)
    zh = torch.stack([seqsum([R[i][k] * hh[k] for k in range(3)]) for i in range(3)], dim=-1)
    B1 = _drq_dqbar(qw, qx, qy, qz, ym)
    B2 = _drq_dqbar(qw, qx, qy, qz, hh)
    zero = torch.zeros_like(w)
    N1 = [[-R[i][0], -R[i][1], -R[i][2]] + B1[i] + R[i] + [zero] * 3 for i in range(3)]
    N2 = [[zero] * 3 + B2[i] + [zero] * 3 + R[i] for i in range(3)]
    C = torch.cat([torch.cat([Pxx7, P12], -1), torch.cat([P12.mT, P22], -1)], -2)   # [.., 13, 13]

    def s(t):  # a [...] scalar against the [..., n] rows of C or CN
        return t[..., None]

    CN1 = torch.stack([seqsum([C[..., :, k] * s(N1[i][k]) for k in NZ1]) for i in range(3)], -1)
    CN2 = torch.stack([seqsum([C[..., :, k] * s(N2[i][k]) for k in NZ2]) for i in range(3)], -1)
    K0 = torch.stack([seqsum([s(N1[i][k]) * CN1[..., k, :] for k in NZ1]) for i in range(3)], -2)
    K12 = torch.stack([seqsum([s(N1[i][k]) * CN2[..., k, :] for k in NZ1]) for i in range(3)], -2)
    K2 = torch.stack([seqsum([s(N2[i][k]) * CN2[..., k, :] for k in NZ2]) for i in range(3)], -2)
    return zr, zh, K0, K12 + K12.mT, K2


def particle_tail(lam: torch.Tensor, zr, zh, K0, Ks, K2, c: ParticleConsts) -> torch.Tensor:
    """[..., 8, NP] prediction rows (ROW_*) for the depths lam [..., NP]."""
    def k(v):
        return torch.full((), v, dtype=lam.dtype, device=lam.device)

    x = zr[..., 0, None] + lam * zh[..., 0, None]
    y = zr[..., 1, None] + lam * zh[..., 1, None]
    z = zr[..., 2, None] + lam * zh[..., 2, None]
    invz = 1.0 / z
    ucx = -c.fku * x * invz
    ucy = -c.fkv * y * invz
    r2 = ucx * ucx + ucy * ucy
    d = 1.0 + 2.0 * c.kd1 * r2
    d12 = torch.sqrt(d)
    hu = ucx / d12 + c.u0c
    hv = ucy / d12 + c.v0c

    # A = dh_by_duc @ duc_by_dy (camera.cpp:183-215)
    c1 = 1.0 / d12
    c3 = k(-2.0 * c.kd1) / (d12 * d)
    m00 = ucx * ucx * c3 + c1
    m01 = ucx * ucy * c3
    m11 = ucy * ucy * c3 + c1
    j00 = -c.fku * invz
    j11 = -c.fkv * invz
    j02 = c.fku * x * invz * invz
    j12 = c.fkv * y * invz * invz
    a00, a01, a02 = m00 * j00, m01 * j11, m00 * j02 + m01 * j12
    a10, a11, a12 = m01 * j00, m11 * j11, m01 * j02 + m11 * j12

    lam2 = lam * lam

    def kl(i, j):
        return K0[..., i, j, None] + lam * Ks[..., i, j, None] + lam2 * K2[..., i, j, None]

    k00, k01, k02 = kl(0, 0), kl(0, 1), kl(0, 2)
    k11, k12, k22 = kl(1, 1), kl(1, 2), kl(2, 2)
    t00 = a00 * k00 + a01 * k01 + a02 * k02
    t01 = a00 * k01 + a01 * k11 + a02 * k12
    t02 = a00 * k02 + a01 * k12 + a02 * k22
    t10 = a10 * k00 + a11 * k01 + a12 * k02
    t11 = a10 * k01 + a11 * k11 + a12 * k12
    t12 = a10 * k02 + a11 * k12 + a12 * k22
    s00 = t00 * a00 + t01 * a01 + t02 * a02
    s01 = t00 * a10 + t01 * a11 + t02 * a12
    s11 = t10 * a10 + t11 * a11 + t12 * a12

    du = hu - c.u0c
    dv = hv - c.v0c
    dist = torch.sqrt(du * du + dv * dv)
    sd = c.sd0 * (1.0 + dist / k(c.maxdist))
    rr = sd * sd
    s00 = s00 + rr
    s11 = s11 + rr
    det = s00 * s11 - s01 * s01

    # S^-1 via the 2x2 LLT (monoslam.cpp:371-374, feature_init_info.cpp:57-65)
    l11 = torch.sqrt(s00)
    l21 = s01 / l11
    l22 = torch.sqrt(s11 - l21 * l21)
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i21 = -l21 * i11 * i22
    q00 = i11 * i11 + i21 * i21
    q01 = i21 * i22
    q11 = i22 * i22
    ns = k(c.no_sigma)
    hw = torch.floor(ns / torch.sqrt(q00 - q01 * q01 / q11))
    hh = torch.floor(ns / torch.sqrt(q11 - q01 * q01 / q00))
    return torch.stack([hu, hv, q00, q01, q11, det, hw, hh], dim=-2)


def kform_rows_plain(zeroed, K0, Ksym, K2, lam, c: ParticleConsts) -> torch.Tensor:
    """Plain PyTorch K10b's rows: zeroed [F, 6] (zr, zh), K0 / Ksym / K2
    [F, 3, 3], lam [F, NP] f32 -> [F, 8, padded_lanes(NP)], the lanes beyond
    NP at lambda = 1."""
    return particle_tail(pad_lambda(lam), zeroed[:, :3], zeroed[:, 3:], K0, Ksym, K2, c)


def kform_outputs(rows: torch.Tensor, NP: int):
    """(hpi [F, NP, 2], sinv [F, NP, 2, 2], dets, hw, hh [F, NP]) of K10b's
    rows, as the TPU wrapper unpacks them (pallas_particle.py:207-214): S^-1
    assembled symmetric from its S01 row."""
    r = rows[:, :, :NP]
    hpi = torch.stack([r[:, ROW_HU], r[:, ROW_HV]], dim=-1)
    sinv = torch.stack([r[:, ROW_S00], r[:, ROW_S01], r[:, ROW_S01], r[:, ROW_S11]], dim=-1)
    return hpi, sinv.reshape(r.shape[0], NP, 2, 2), r[:, ROW_DET], r[:, ROW_HW], r[:, ROW_HH]


def particle_predict_kform_plain(zeroed, K0, Ksym, K2, lam, fku=195.0, fkv=195.0, u0c=162.0,
                                 v0c=125.0, kd1=9e-6, sd0=1.0, no_sigma=3.0):
    """Plain PyTorch K10b, with pallas_particle_predict's arguments and
    defaults. Returns (hpi [F, NP, 2], sinv [F, NP, 2, 2], dets [F, NP],
    hw [F, NP], hh [F, NP])."""
    c = ParticleConsts.of(fku, fkv, u0c, v0c, kd1, sd0, no_sigma)
    rows = kform_rows_plain(*(t.to(torch.float32) for t in (zeroed, K0, Ksym, K2, lam)), c)
    return kform_outputs(rows, lam.shape[-1])


def kform_rows(zeroed, K0, Ksym, K2, lam, c: ParticleConsts) -> torch.Tensor:
    """K10b's rows [F, 8, padded_lanes(NP)]. CPU tensors take the plain
    version (kform_rows_plain); CUDA tensors launch the kernel (or raise)."""
    if lam.device.type == "cpu":
        return kform_rows_plain(zeroed, K0, Ksym, K2, lam, c)
    Fn, NP = lam.shape
    lanes = padded_lanes(NP)
    f32 = torch.float32
    par = torch.cat([zeroed.reshape(Fn, 6), K0.reshape(Fn, 9), Ksym.reshape(Fn, 9), K2.reshape(Fn, 9)],
                    dim=-1).to(f32).contiguous()
    lam = lam.to(f32).contiguous()
    _build.check_tensor(par, "zeroed / K0 / Ksym / K2", f32, (Fn, 33))
    _build.check_tensor(lam, "lam", f32, (Fn, NP))
    out = torch.empty((Fn, 8, lanes), dtype=f32, device=lam.device)
    prm = _K10bParams(F=Fn, NP=NP, lanes=lanes, fku=c.fku, fkv=c.fkv, u0c=c.u0c, v0c=c.v0c,
                      two_kd1=2.0 * c.kd1, neg_two_kd1=-2.0 * c.kd1, sd0=c.sd0, maxdist=c.maxdist,
                      no_sigma=c.no_sigma)
    fn = _build.function(NAME_KFORM, "k10b_particle_kform", _ARGTYPES_KFORM)
    err = fn(par.data_ptr(), lam.data_ptr(), out.data_ptr(), ctypes.byref(prm),
             torch.cuda.current_stream(lam.device).cuda_stream)
    _build.check(err, "K10b particle_kform")
    _build.launches[NAME_KFORM] += 1
    return out


def particle_predict_kform(zeroed, K0, Ksym, K2, lam, fku=195.0, fkv=195.0, u0c=162.0, v0c=125.0,
                           kd1=9e-6, sd0=1.0, no_sigma=3.0):
    """K10b, with pallas_particle_predict's arguments in its order and its
    defaults: zeroed [F, 6], K0 / Ksym / K2 [F, 3, 3], lam [F, NP]. Returns
    (hpi [F, NP, 2], sinv [F, NP, 2, 2], dets, hw, hh [F, NP]) f32. CPU
    tensors take the plain version; CUDA tensors launch the kernel (or
    raise)."""
    c = ParticleConsts.of(fku, fkv, u0c, v0c, kd1, sd0, no_sigma)
    return kform_outputs(kform_rows(zeroed, K0, Ksym, K2, lam, c), lam.shape[-1])


def pack_rows_batch(xp, pxx7, ys6, pxy, pyy):
    """The shared rows [B, 56] and slot rows [B, F, 84] from the TPU
    wrapper's operands (pallas_particle.py:413-423): xp [B, 7], pxx7
    [B, 7, 7], ys6 [B, F, 6], pxy [B, F, 13, 6] (the camera-slot cross
    blocks; the first 7 camera rows are used), pyy [B, F, 6, 6]."""
    Bn, Fn = ys6.shape[:2]
    shared = torch.cat([xp, pxx7.reshape(Bn, 49)], dim=-1)
    slot = torch.cat([ys6, pxy[:, :, :7, :].reshape(Bn, Fn, 42), pyy.reshape(Bn, Fn, 36)], dim=-1)
    return shared, slot


def pad_lambda(lam: torch.Tensor) -> torch.Tensor:
    """lam [..., NP] on the padded row of padded_lanes(NP) lanes, 1.0 in the
    padding lanes (the TPU wrappers' padding: it keeps the chain finite)."""
    NP = lam.shape[-1]
    pad = torch.ones((*lam.shape[:-1], padded_lanes(NP) - NP), dtype=lam.dtype, device=lam.device)
    return torch.cat([lam, pad], dim=-1)


def particle_predict_plain(shared, slot_rows, lam, c: ParticleConsts):
    """Plain PyTorch K10. shared [B, 56], slot_rows [B, F, 84], lam
    [B, F, NP] f32. Returns the [B, F, 8, padded_lanes(NP)] prediction rows;
    the lanes beyond NP are computed at lambda = 1."""
    return particle_tail(pad_lambda(lam), *geometry_prologue(shared[:, None, :], slot_rows), c)


class _K10Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("n_lanes", "F", "NP", "lanes")]
                + [(n, ctypes.c_float) for n in (
                    "fku", "fkv", "u0c", "v0c", "two_kd1", "neg_two_kd1", "sd0", "maxdist",
                    "no_sigma")])


# tensor pointers (shared, slot rows, lam, the output), the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.POINTER(_K10Params), ctypes.c_void_p]


def particle_predict(shared, slot_rows, lam, c: ParticleConsts):
    """K10. CPU tensors take the plain version; CUDA tensors launch the
    kernel (or raise). Same output as particle_predict_plain."""
    if lam.device.type == "cpu":
        return particle_predict_plain(shared, slot_rows, lam, c)
    Bn, Fn, NP = lam.shape
    lanes = padded_lanes(NP)
    f32 = torch.float32
    shared, slot_rows, lam = shared.contiguous(), slot_rows.contiguous(), lam.contiguous()
    _build.check_tensor(shared, "shared", f32, (Bn, NSHARED))
    _build.check_tensor(slot_rows, "slot_rows", f32, (Bn, Fn, NSLOT))
    _build.check_tensor(lam, "lam", f32, (Bn, Fn, NP))
    out = torch.empty((Bn, Fn, 8, lanes), dtype=f32, device=lam.device)
    prm = _K10Params(n_lanes=Bn, F=Fn, NP=NP, lanes=lanes, fku=c.fku, fkv=c.fkv, u0c=c.u0c, v0c=c.v0c,
                     two_kd1=2.0 * c.kd1, neg_two_kd1=-2.0 * c.kd1, sd0=c.sd0,
                     maxdist=c.maxdist, no_sigma=c.no_sigma)
    fn = _build.function(NAME, "k10_particle_predict", _ARGTYPES)
    err = fn(shared.data_ptr(), slot_rows.data_ptr(), lam.data_ptr(), out.data_ptr(),
             ctypes.byref(prm), torch.cuda.current_stream(lam.device).cuda_stream)
    _build.check(err, "K10 particle_predict")
    _build.launches[NAME] += 1
    return out


class _K10bParams(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("F", "NP", "lanes")] + _K10Params._fields_[4:])


# tensor pointers (the geometry rows, lam, the output), the params struct, the stream
_ARGTYPES_KFORM = [ctypes.c_void_p] * 3 + [ctypes.POINTER(_K10bParams), ctypes.c_void_p]


def bytes_and_flops_kform(Fn: int, NP: int) -> tuple[int, int]:
    """Least bytes (each slot's 33 geometry values and its NP depths in;
    hpi, sinv, dets, hw, hh out: 9 values a particle) and operations (~90
    per particle) of one K10b call."""
    return Fn * (33 + NP) * 4 + Fn * NP * 9 * 4, Fn * 90 * NP


def bytes_and_flops(Bn: int, Fn: int, NP: int) -> tuple[int, int]:
    """Least bytes (rows in, the NP particles' 8 prediction values out: the
    padding lanes of the rows are read by no one) and operations (~1.5 k of
    the prologue per slot, ~90 per particle) of one K10 call."""
    nbytes = Bn * NSHARED * 4 + Bn * Fn * (NSLOT + NP) * 4 + Bn * Fn * 8 * NP * 4
    return nbytes, Bn * Fn * (1500 + 90 * NP)
