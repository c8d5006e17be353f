"""K5: auto-init region proposal (rollforward, safe box, occupancy, drand48 tries).

Replaces the TPU kernel scenelib2_tpu/kernels/pallas_propose.py
(``pallas_propose_init`` / ``_kernel``), the first half of stage 7
(reference AutoInitialiseFeature / FindNonOverlappingRegion,
monoslam.cpp:823-1032). In f32, operation for operation:

  the constant-velocity rollforward collapsed to r + N dt v and one rotation
    by N dt omega (sin/cos of the half angle);
  the future image point of a point at the init depth ahead of the future
    camera, and the safe box around the image centre it implies (trunc);
  the projections of every active full feature (one lane per slot);
  2 * tries drand48 draws on the limb state, each value made in f32 from
    the limbs as the TPU kernel makes it;
  the region tries (trunc of span * draw), each clashing with any occupied
    projection within the separation margin; the first try that does not
    clash; the number of draws consumed (0 without an attempt, 2*(i+1) at
    the first free try i, 2*tries when every try clashes) and the limbs after
    them.

Outputs: region_us, region_vs ([] i32; a non-finite region, which only
arises without room, converts as 0, and the values are clamped to +-2^20
first), any_ok ([] bool), rng_new ([3] i32 limbs).

Bound on an H100: ~1 KB in and a few hundred scalar operations: nothing;
the launch dominates. Design: one block of 128 threads; thread 0 runs the
scalar chain and the draws (64-bit integer arithmetic, whose limbs equal
the 16-bit limb arithmetic's), one lane per slot projects the occupancy
points, and one block-wide OR per try decides its clash.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from scenelib2_torch.core.quaternion import (
    quat_from_angular_velocity_parts,
    quat_mul_parts,
    quat_to_rotation_parts,
)
from scenelib2_torch.kernels import _build
from scenelib2_torch.rng import drand48_many

NAME = "propose"
REGION_LIM = float(1 << 20)


@dataclass(frozen=True)
class ProposeConsts:
    H: int
    W: int
    region_w: int
    region_h: int
    boxsize: int
    tries: int
    sep: int
    dtN: float
    depth: float
    fku: float
    fkv: float
    u0c: float
    v0c: float
    kd1: float

    @staticmethod
    def from_params(p) -> "ProposeConsts":
        return ProposeConsts(
            H=p.cam_height, W=p.cam_width, region_w=p.init_search_width,
            region_h=p.init_search_height, boxsize=p.boxsize, tries=p.init_region_tries,
            sep=p.feature_separation_min, dtN=p.init_steps_to_predict * p.delta_t,
            depth=p.init_depth_hypothesis, fku=p.cam_fku, fkv=p.cam_fkv, u0c=p.cam_u0,
            v0c=p.cam_v0, kd1=p.cam_kd1,
        )


def _rot_i(Ri, r, y):
    """R_RW (y - r), each row summed left to right."""
    m = [y[i] - r[i] for i in range(3)]
    return [(Ri[i][0] * m[0] + Ri[i][1] * m[1]) + Ri[i][2] * m[2] for i in range(3)]


def _project(z, c: ProposeConsts):
    uc0 = -c.fku * z[0] / z[2]
    uc1 = -c.fkv * z[1] / z[2]
    factor = torch.sqrt(1.0 + 2.0 * c.kd1 * (uc0 * uc0 + uc1 * uc1))
    return uc0 / factor + c.u0c, uc1 / factor + c.v0c


def draw_values_f32(states: torch.Tensor) -> torch.Tensor:
    """drand48 values in f32 from [n, 3] limbs, as the TPU kernel forms them
    (pallas_propose.py:175-182): ((r2 2^32 + r1 2^16) + r0) * 2^-48, each
    operation rounded to f32."""
    f = states.to(torch.float32)
    return (f[:, 2] * (65536.0 * 65536.0) + f[:, 1] * 65536.0 + f[:, 0]) * (1.0 / float(1 << 48))


def _to_i32(v: torch.Tensor) -> torch.Tensor:
    return torch.nan_to_num(v, nan=0.0).clamp(-REGION_LIM, REGION_LIM).to(torch.int32)


def _pick(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """t[i] for a 0-dim index tensor, without reading i on the host."""
    return t.index_select(0, i.reshape(1)).squeeze(0)


def propose_plain(x, rng, occ_flags, want, c: ProposeConsts):
    """Plain PyTorch K5. x [D] f32 (camera part and slot points read),
    rng [3] i32 limbs, occ_flags [MF] bool (active & full), want [] bool.
    Returns (region_us [] i32, region_vs [] i32, any_ok [] bool, rng_new [3] i32)."""
    dev = x.device
    MF = occ_flags.shape[0]
    half = (c.boxsize - 1) // 2
    RW, RH = float(c.region_w), float(c.region_h)

    def k(v):
        return torch.full((), v, dtype=torch.float32, device=dev)

    r = [x[i] for i in range(3)]
    q = [x[3 + i] for i in range(4)]
    v = [x[7 + i] for i in range(3)]
    om = [x[10 + i] for i in range(3)]

    # collapsed constant-velocity rollforward
    qf = quat_mul_parts(q, quat_from_angular_velocity_parts([o * c.dtN for o in om]))
    rf = [r[i] + v[i] * c.dtN for i in range(3)]
    Rf = quat_to_rotation_parts(qf)
    yW = [rf[i] + Rf[i][2] * c.depth for i in range(3)]
    # its projection from the current camera: R_RW = R(conj(q) * (1 / |q|^2))
    inv_n2 = 1.0 / (q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    Ri = quat_to_rotation_parts([q[0] * inv_n2, -q[1] * inv_n2, -q[2] * inv_n2, -q[3] * inv_n2])
    hf_u, hf_v = _project(_rot_i(Ri, r, yW), c)
    pm_u = c.W / 2.0 - hf_u
    pm_v = c.H / 2.0 - hf_v
    lo = k(float(half + 1))
    safe_us = torch.maximum(torch.trunc(-pm_u), lo)
    safe_uf = torch.minimum(torch.trunc(c.W - pm_u), k(float(c.W - half - 1)))
    safe_vs = torch.maximum(torch.trunc(-pm_v), lo)
    safe_vf = torch.minimum(torch.trunc(c.H - pm_v), k(float(c.H - half - 1)))
    room = (safe_uf - safe_us > RW) & (safe_vf - safe_vs > RH)

    # occupancy: current projections of the active full features
    ys = x[13 : 13 + 6 * MF].reshape(MF, 6)
    zz = _rot_i(Ri, r, [ys[:, 0], ys[:, 1], ys[:, 2]])
    hn_u, hn_v = _project(zz, c)
    occupied = occ_flags & (zz[2] > 0.0)

    # 2 * tries draws and the tries
    states, _ = drand48_many(rng, 2 * c.tries)
    vals = draw_values_f32(states)
    span_u = safe_uf - safe_us - RW
    span_v = safe_vf - safe_vs - RH
    us_all = safe_us + torch.trunc(span_u * vals[0::2])                # [tries]
    vs_all = safe_vs + torch.trunc(span_v * vals[1::2])
    clash = (occupied[None, :]
             & (hn_u[None, :] >= (us_all - float(c.sep))[:, None])
             & (hn_u[None, :] < (us_all + float(c.region_w + c.sep))[:, None])
             & (hn_v[None, :] >= (vs_all - float(c.sep))[:, None])
             & (hn_v[None, :] < (vs_all + float(c.region_h + c.sep))[:, None])).any(dim=1)
    ok = ~clash
    attempt = want & room
    any_ok_raw = ok.any()
    any_ok = any_ok_raw & attempt
    first_ok = torch.argmax(ok.to(torch.int32))                       # first True, 0 if none
    consumed = torch.where(attempt, torch.where(any_ok_raw, 2 * (first_ok + 1), 2 * c.tries), 0)
    rng_new = torch.where(consumed == 0, rng, _pick(states, torch.clamp(consumed - 1, min=0)))
    return _to_i32(_pick(us_all, first_ok)), _to_i32(_pick(vs_all, first_ok)), any_ok, rng_new


class _K5Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "region_w", "region_h", "boxsize",
                                             "tries", "sep", "MF")]
                + [(n, ctypes.c_float) for n in ("dtN", "depth", "fku", "fkv", "u0c", "v0c",
                                                 "two_kd1")])


# tensor pointers (x, rng, occ, want, 4 outputs), the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.POINTER(_K5Params), ctypes.c_void_p]


def propose(x, rng, occ_flags, want, c: ProposeConsts):
    """K5. A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (or raises). Same outputs as propose_plain."""
    if x.device.type == "cpu":
        return propose_plain(x, rng, occ_flags, want, c)
    MF = occ_flags.shape[0]
    D = x.shape[0]
    if not (D == 13 + 6 * MF and MF <= 128 and 1 <= c.tries <= 16):
        raise ValueError(f"K5: unsupported shapes D={D} MF={MF} tries={c.tries}")
    _build.check_tensor(x, "x", torch.float32, (D,))
    _build.check_tensor(rng, "rng", torch.int32, (3,))
    _build.check_tensor(occ_flags, "occ_flags", torch.bool, (MF,))
    _build.check_tensor(want, "want", torch.bool, ())
    dev = x.device
    us = torch.empty((), dtype=torch.int32, device=dev)
    vs = torch.empty((), dtype=torch.int32, device=dev)
    any_ok = torch.empty((), dtype=torch.bool, device=dev)
    rng_new = torch.empty(3, dtype=torch.int32, device=dev)
    prm = _K5Params(H=c.H, W=c.W, region_w=c.region_w, region_h=c.region_h, boxsize=c.boxsize,
                    tries=c.tries, sep=c.sep, MF=MF, dtN=c.dtN, depth=c.depth, fku=c.fku,
                    fkv=c.fkv, u0c=c.u0c, v0c=c.v0c, two_kd1=2.0 * c.kd1)
    fn = _build.function(NAME, "k5_propose", _ARGTYPES)
    err = fn(x.data_ptr(), rng.data_ptr(), occ_flags.data_ptr(), want.data_ptr(), us.data_ptr(),
             vs.data_ptr(), any_ok.data_ptr(), rng_new.data_ptr(), ctypes.byref(prm),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K5 propose")
    _build.launches[NAME] += 1
    return us, vs, any_ok, rng_new


def bytes_and_flops(MF: int, tries: int) -> tuple[int, int]:
    """Least bytes (the camera state and slot points in, four results out)
    and operations of one K5 call: ~150 scalar operations of the chain, ~40
    per slot projection and 5 compares per slot and try."""
    nbytes = (13 + 3 * MF) * 4 + 3 * 4 + MF + 1 + 4 + 4 + 1 + 3 * 4
    flops = 150 + 40 * MF + 5 * MF * tries + 12 * 2 * tries
    return nbytes, flops
