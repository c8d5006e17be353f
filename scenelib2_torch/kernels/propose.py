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

Outputs of ``propose_plain`` (the JAX kernel's arguments and results, held
against it by the tests): region_us, region_vs ([] i32; a non-finite
region, which only arises without room, converts as 0, and the values are
clamped to +-2^20 first), any_ok ([] bool), rng_new ([3] i32 limbs).

The step runs K5 as ``propose_region``: the kernel also takes the step's
glue around the TPU kernel (the gate on speed, the visible count and the
partial slots; the region's clamp to the frame; the init box the step
reports), so stage 7's proposal is one launch; its twin
``propose_region_plain`` composes that glue with ``propose_plain``.

Bound on an H100: ~1 KB in and a few hundred scalar operations: nothing;
the launch and the dependent scalar chains set the time. Design
(csrc/propose.cu): one block; thread 0 runs the rollforward and the safe
box while a thread per slot projects the occupancy points; each draw is
one jump ahead from the input state (x_k = A_k x_0 + C_k mod 2^48 in 64-bit
integers, whose limbs equal the 16-bit limb arithmetic's), from the table
``jump_table`` makes once on the host and uploads once; each warp takes
every nwarps-th try and a shared minimum keeps the first free one. Any
number of tries: two block barriers after the safe box whatever it is.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import NamedTuple

import torch

from scenelib2_torch.core.quaternion import (
    quat_from_angular_velocity_parts,
    quat_mul_parts,
    quat_to_rotation_parts,
)
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.shi_tomasi import clamp_region
from scenelib2_torch.rng import drand48_many, jump_constants

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
    # the step's gate (propose_region): speed, visible count, partial count
    min_speed: float
    keep_visible: int
    max_init: int

    @staticmethod
    def from_params(p) -> "ProposeConsts":
        return ProposeConsts(
            H=p.cam_height, W=p.cam_width, region_w=p.init_search_width,
            region_h=p.init_search_height, boxsize=p.boxsize, tries=p.init_region_tries,
            sep=p.feature_separation_min, dtN=p.init_steps_to_predict * p.delta_t,
            depth=p.init_depth_hypothesis, fku=p.cam_fku, fkv=p.cam_fkv, u0c=p.cam_u0,
            v0c=p.cam_v0, kd1=p.cam_kd1, min_speed=p.min_speed_for_init,
            keep_visible=p.n_features_to_keep_visible, max_init=p.max_features_to_init_at_once,
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


class Region(NamedTuple):
    """Stage 7's proposal as the step reads it (propose_region)."""
    ru: torch.Tensor        # [] i32, the region clamped to the frame (clamp_region)
    rv: torch.Tensor
    ruf: torch.Tensor
    rvf: torch.Tensor
    any_ok: torch.Tensor    # [] bool
    rng_new: torch.Tensor   # [3] i32
    init_box: torch.Tensor  # [2] i32, the unclamped region where the gate wants an init, else 0


def init_gate(active, full, speed, n_visible, c: ProposeConsts):
    """The step's auto-init gate (step.py want_init): fast enough, too few
    visible features, room for another partial feature."""
    n_partial = (active & ~full).sum().to(torch.int32)
    return (speed > c.min_speed) & (n_visible < c.keep_visible) & (n_partial < c.max_init)


def propose_region_plain(x, rng, active, full, speed, n_visible, c: ProposeConsts) -> Region:
    """Plain PyTorch K5 with the step's glue: the gate, propose_plain on the
    active full slots, the region's clamp and the reported init box.
    x [D] f32, rng [3] i32, active, full [MF] bool, speed [] f32, n_visible
    [] i32."""
    want = init_gate(active, full, speed, n_visible, c)
    us, vs, any_ok, rng_new = propose_plain(x, rng, active & full, want, c)
    ru, rv, ruf, rvf = clamp_region(us, vs, us + c.region_w, vs + c.region_h, c.W, c.H, c.boxsize)
    box = torch.stack([us, vs])
    return Region(ru, rv, ruf, rvf, any_ok, rng_new, torch.where(want, box, torch.zeros_like(box)))


class _K5Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "region_w", "region_h", "boxsize",
                                             "tries", "sep", "MF", "keep_visible", "max_init")]
                + [(n, ctypes.c_float) for n in ("dtN", "depth", "fku", "fkv", "u0c", "v0c",
                                                 "two_kd1", "min_speed")])


# tensor pointers (x, rng, active, full, speed, n_visible, the jump table,
# 3 outputs), the params struct, the stream
_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.POINTER(_K5Params), ctypes.c_void_p]
MAX_MF = 128   # csrc/propose.cu K5_MAX_MF: JAX's step needs it too (step.py:707-708)


@functools.lru_cache(maxsize=None)
def jump_table(tries: int, device: str) -> torch.Tensor:
    """[2 tries, 2] int64 (A_k, C_k) on `device`: draw k (k = 1 .. 2 tries)
    from the state x_0 is (A_k x_0 + C_k) mod 2^48. Made from Python ints
    once per (tries, device) and uploaded once, so that no step copies a
    host constant (a blocking copy); the step builds it when it is built."""
    ai, ci = jump_constants(2 * tries)
    return torch.tensor(list(zip(ai, ci)), dtype=torch.int64, device=device)


def propose_region(x, rng, active, full, speed, n_visible, c: ProposeConsts) -> Region:
    """K5 as the step runs it: the gate, the proposal and the region's
    clamp in one launch, at any c.tries. CPU tensors take
    propose_region_plain; CUDA tensors launch the kernel (or raise)."""
    if x.device.type == "cpu":
        return propose_region_plain(x, rng, active, full, speed, n_visible, c)
    MF = active.shape[0]
    D = x.shape[0]
    if not (D == 13 + 6 * MF and 1 <= MF <= MAX_MF and c.tries >= 1):
        raise ValueError(f"K5: unsupported shapes D={D} MF={MF} tries={c.tries}")
    for t, name, dty, shp in zip(
        (x, rng, active, full, speed, n_visible), ("x", "rng", "active", "full", "speed", "n_visible"),
        (torch.float32, torch.int32, torch.bool, torch.bool, torch.float32, torch.int32),
        ((D,), (3,), (MF,), (MF,), (), ()),
    ):
        _build.check_tensor(t, name, dty, shp)
    dev = x.device
    table = jump_table(c.tries, str(dev))
    any_ok = torch.empty((), dtype=torch.bool, device=dev)
    rng_new = torch.empty(3, dtype=torch.int32, device=dev)
    region = torch.empty(6, dtype=torch.int32, device=dev)
    prm = _K5Params(H=c.H, W=c.W, region_w=c.region_w, region_h=c.region_h, boxsize=c.boxsize,
                    tries=c.tries, sep=c.sep, MF=MF, keep_visible=c.keep_visible,
                    max_init=c.max_init, dtN=c.dtN, depth=c.depth, fku=c.fku, fkv=c.fkv,
                    u0c=c.u0c, v0c=c.v0c, two_kd1=2.0 * c.kd1, min_speed=c.min_speed)
    fn = _build.function(NAME, "k5_propose", _ARGTYPES)
    err = fn(x.data_ptr(), rng.data_ptr(), active.data_ptr(), full.data_ptr(), speed.data_ptr(),
             n_visible.data_ptr(), table.data_ptr(), any_ok.data_ptr(), rng_new.data_ptr(),
             region.data_ptr(), ctypes.byref(prm), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "K5 propose")
    _build.launches[NAME] += 1
    return Region(region[0], region[1], region[2], region[3], any_ok, rng_new, region[4:])


def bytes_and_flops(MF: int, tries: int) -> tuple[int, int]:
    """Least bytes (the camera state, slot points, limbs, the two masks,
    speed and the visible count in; any_ok, the limbs and the region out:
    not the jump table, which is this kernel's design and not the
    function's) and operations of one propose_region call: ~150 scalar
    operations of the chain, ~40 per slot projection, 12 per draw, 5
    compares per slot and try, ~20 for the gate and the clamp."""
    nbytes = (13 + 3 * MF) * 4 + 3 * 4 + 2 * MF + 4 + 4 + 1 + 3 * 4 + 6 * 4
    flops = 150 + 40 * MF + 5 * MF * tries + 12 * 2 * tries + 20
    return nbytes, flops
