"""K17: stage 7's ray insertion, after K5's region and K6's patch pick.

No TPU kernel of the JAX package does this: the JAX step runs it as XLA
ops behind a lax.cond (scenelib2_tpu/runtime/step.py _auto_initialise),
and the port's step ran it as ~370 kernels of tensor operations every
frame with the gate as data (the composition ``ray_insert_plain`` keeps as
K17's twin):

  did_init = any_ok & (evbest > init_patch_score_thresh);
  the B x B patch around (ubest, vbest), its window clamped to the frame
    (as lax.dynamic_slice);
  runtime/state.add_partial_feature on the state with K5's drand48 limbs:
    the ray of models.part_init_ray from h = (ubest, vbest), the slot's rows
    of P dypi_by_dxp P[:7, :], its block with the camera's
    measurement_noise, and every write into the first free slot (x, P's
    rows, then its columns, then the block; active, full, label, patches,
    patch_rows, xp_org, attempts, successes, lam, prob, palive,
    match_attempts, sched; next_label), each the slot's old content where
    the gate is shut or the map is full.

``ray_insert`` runs the composition in one launch on CUDA tensors
(csrc/ray_insert.cu) and the composition itself on CPU tensors. The kernel
writes every field into tensors the wrapper allocates, so no tensor the
step received is written; rng is K5's tensor and frame_no the state's.

Bound on an H100 (bytes_and_flops): P read once and written once (D^2
floats each way: 95 KB at D = 109, 4.9 MB at D = 781), the per-slot
fields likewise, and ~300 scalar operations plus 7 multiply-adds an entry
of the six new rows: 0.04 us at D = 109, where the kernel's ~6 us are the
dependent scalar chain and a few dependent trips to memory. Design:
csrc/ray_insert.cu, a grid over bands of ``band_rows`` rows of P, every CTA
recomputing the scalar chain in one thread while its other warps copy.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from scenelib2_torch.config import Params
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.kernels import _build
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime.state import CAM_DIM, SLOT_DIM, SlamState

NAME = "ray_insert"
MAX_MF = 128        # csrc/ray_insert.cu K17_MAX_MF: the fast step's slots
THREADS = 256       # K17_THREADS
MAX_ROWS = 32       # K17_MAX_ROWS: P's rows a CTA's band holds at most
MIN_ROWS = 2        # the narrowest band the wrapper makes
PATCH_ROW = 128     # K17_PATCH_ROW: state.patch_row's width


@dataclass(frozen=True)
class RayInsertConsts:
    H: int
    W: int
    boxsize: int
    thresh: float   # init_patch_score_thresh
    cam: CameraParams

    @staticmethod
    def from_params(p: Params) -> "RayInsertConsts":
        return RayInsertConsts(H=p.cam_height, W=p.cam_width, boxsize=p.boxsize,
                               thresh=p.init_patch_score_thresh, cam=CameraParams.from_params(p))


def ray_insert_plain(state: SlamState, frame_u8, ubest, vbest, evbest, any_ok, rng_new, lam0,
                     c: RayInsertConsts) -> tuple[SlamState, torch.Tensor]:
    """Plain PyTorch K17: the init decision, the patch and
    state.add_partial_feature on the state (without lanes) with rng_new.
    frame_u8 [H, W] u8; ubest, vbest [] i32 and evbest [] f32 from K6;
    any_ok [] bool and rng_new [3] i32 from K5; lam0 [NP]. Returns
    (state', did_init [] bool)."""
    did_init = any_ok & (evbest > c.thresh)
    # the patch around the pick (a clamped window, as lax.dynamic_slice)
    B = c.boxsize
    half = (B - 1) // 2
    offs = torch.arange(B, device=frame_u8.device) - half
    pr = torch.clamp(vbest.long() - half, 0, c.H - B) + half + offs
    pcol = torch.clamp(ubest.long() - half, 0, c.W - B) + half + offs
    patch = frame_u8[pr[:, None], pcol[None, :]]
    h = torch.stack([ubest, vbest]).to(state.x.dtype)
    out = st.add_partial_feature(state._replace(rng=rng_new), c.cam, h, patch, lam0, did_init)
    return out, did_init


class _K17Params(ctypes.Structure):
    _fields_ = ([(n, ctypes.c_int) for n in ("H", "W", "B", "MF", "NP", "D", "rows")]
                + [(n, ctypes.c_float) for n in ("thresh", "u0", "v0", "neg_fku", "neg_fkv", "two_kd1",
                                                 "a", "b", "sd", "prob0")])


# the step's inputs, the state's fields in, the fields out (csrc/ray_insert.cu K17Ptrs)
IN_FIELDS = ("x", "P", "active", "full", "label", "patches", "xp_org", "attempts", "successes",
             "patch_rows", "lam", "prob", "palive", "match_attempts", "sched", "next_label")
PTR_FIELDS = (("frame", "ubest", "vbest", "evbest", "any_ok", "lam0") + IN_FIELDS
              + tuple(f"{n}_o" for n in IN_FIELDS) + ("did_init_o",))


class _K17Ptrs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in PTR_FIELDS]


_ARGTYPES = [ctypes.POINTER(_K17Ptrs), ctypes.POINTER(_K17Params), ctypes.c_void_p]


def band_rows(D: int, n_sms: int) -> int:
    """P's rows a CTA copies: P spread over the SMs, at least MIN_ROWS and at
    most MAX_ROWS rows a band."""
    return min(MAX_ROWS, max(MIN_ROWS, math.ceil(D / n_sms)))


def ray_insert(state: SlamState, frame_u8, ubest, vbest, evbest, any_ok, rng_new, lam0,
               c: RayInsertConsts) -> tuple[SlamState, torch.Tensor]:
    """K17 as the step runs it: ray_insert_plain's results in one launch.
    CPU tensors take ray_insert_plain; CUDA tensors launch the kernel (or
    raise)."""
    if state.x.device.type == "cpu":
        return ray_insert_plain(state, frame_u8, ubest, vbest, evbest, any_ok, rng_new, lam0, c)
    MF = state.active.shape[0]
    NP = state.lam.shape[-1]
    D = CAM_DIM + SLOT_DIM * MF
    B = c.boxsize
    if not (1 <= MF <= MAX_MF and B * B + 2 <= PATCH_ROW and B <= min(c.H, c.W) and NP >= 1):
        raise ValueError(f"K17: unsupported shapes MF={MF} NP={NP} boxsize={B}")
    f32, i32, u8, b8 = torch.float32, torch.int32, torch.uint8, torch.bool
    shapes = dict(x=(f32, (D,)), P=(f32, (D, D)), active=(b8, (MF,)), full=(b8, (MF,)),
                  label=(i32, (MF,)), patches=(u8, (MF, B, B)), xp_org=(f32, (MF, 7)),
                  attempts=(i32, (MF,)), successes=(i32, (MF,)), patch_rows=(f32, (MF, PATCH_ROW)),
                  lam=(f32, (MF, NP)), prob=(f32, (MF, NP)), palive=(b8, (MF, NP)),
                  match_attempts=(i32, (MF,)), sched=(b8, (MF,)), next_label=(i32, ()))
    ins = state._asdict()
    for n, (dty, shp) in shapes.items():
        _build.check_tensor(ins[n], n, dty, shp)
    for t, n, dty, shp in ((frame_u8, "frame", u8, (c.H, c.W)), (ubest, "ubest", i32, ()),
                           (vbest, "vbest", i32, ()), (evbest, "evbest", f32, ()),
                           (any_ok, "any_ok", b8, ()), (rng_new, "rng_new", i32, (3,)),
                           (lam0, "lam0", f32, (NP,))):
        _build.check_tensor(t, n, dty, shp)
    outs = {n: torch.empty_like(ins[n]) for n in IN_FIELDS}
    did_init = torch.empty((), dtype=b8, device=state.x.device)
    ptrs = _K17Ptrs(frame=frame_u8.data_ptr(), ubest=ubest.data_ptr(), vbest=vbest.data_ptr(),
                    evbest=evbest.data_ptr(), any_ok=any_ok.data_ptr(), lam0=lam0.data_ptr(),
                    did_init_o=did_init.data_ptr(),
                    **{n: ins[n].data_ptr() for n in IN_FIELDS},
                    **{f"{n}_o": outs[n].data_ptr() for n in IN_FIELDS})
    cam = c.cam
    prm = _K17Params(H=c.H, W=c.W, B=B, MF=MF, NP=NP, D=D, rows=band_rows(D, _build.n_sms(state.x.device)),
                     thresh=c.thresh, u0=cam.u0, v0=cam.v0, neg_fku=-cam.fku, neg_fkv=-cam.fkv,
                     two_kd1=2.0 * cam.kd1, a=-1.0 / cam.fku, b=-1.0 / cam.fkv, sd=cam.sd, prob0=1.0 / NP)
    fn = _build.function(NAME, "k17_ray_insert", _ARGTYPES)
    err = fn(ctypes.byref(ptrs), ctypes.byref(prm), torch.cuda.current_stream(state.x.device).cuda_stream)
    _build.check(err, "K17 ray_insert")
    _build.launches[NAME] += 1
    return state._replace(rng=rng_new, **outs), did_init


def bytes_and_flops(MF: int, NP: int, boxsize: int) -> tuple[int, int]:
    """Least bytes (P and x in and out; the per-slot fields in and out; the
    patch's pixels and the step's scalars in) and operations (the ~300 of
    the ray's chain, 13 for each of the six new rows' D entries, 14 for each
    of the block's 36) of one ray_insert call."""
    D = CAM_DIM + SLOT_DIM * MF
    per_slot = MF * (1 + 1 + 4 + 4 + 4 + 4 + 1 + 7 * 4 + boxsize * boxsize + PATCH_ROW * 4 + NP * (4 + 4 + 1))
    nbytes = 2 * (D * D * 4 + D * 4 + per_slot) + boxsize * boxsize + NP * 4 + 4 * 5
    flops = 300 + 13 * SLOT_DIM * D + 14 * SLOT_DIM * SLOT_DIM
    return nbytes, flops
