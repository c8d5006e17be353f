"""SlamState: fixed-capacity masked SoA state on one device.

Port of scenelib2_tpu/runtime/state.py. One packed state vector and ONE
dense joint covariance over fixed feature slots:

  x[D], P[D,D] with D = 13 + 6*MAX_F.

Each feature slot owns a fixed 6-wide stride (rays need 6 dims; 3D points
use the first 3 and keep exact zeros in the rest). Insertion order is
tracked by monotone labels. The field layout is the JAX package's, so a
state converts both ways (scenelib2_torch/convert.py).

The in-step surgery (add_partial_feature with mapping on, convert_feature)
runs every frame with its gate as data: a disabled call writes back what it read, so it is
an exact no-op, and the step needs no host synchronisation to skip it. Slot
indices stay tensors (index_put and one-hot selects, never .item()).

Batch mode stacks B independent states: every field gains a leading lane
dimension (x [B, D], P [B, D, D], active [B, MF], ...). The surgery, the
deletion and the block accessors take either form; the surgery is written
once, over lanes, and a state without lanes runs through it as one lane
(the same element-wise arithmetic, so the single stream is unchanged).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scenelib2_torch.config import Params, SlamConfig
from scenelib2_torch.core import models
from scenelib2_torch.core.camera import CameraParams, measurement_noise
from scenelib2_torch.core.quaternion import mm_seq
from scenelib2_torch.io.pgm import read_pgm
from scenelib2_torch.rng import pack_state, srand48

CAM_DIM = 13
SLOT_DIM = 6


class SlamState(NamedTuple):
    # filter state
    x: torch.Tensor          # [D] packed state (f32 fast mode / f64 parity)
    P: torch.Tensor          # [D,D] joint covariance
    # per-slot feature records
    active: torch.Tensor     # [MF] bool
    full: torch.Tensor       # [MF] bool (fully-initialised flag)
    label: torch.Tensor      # [MF] i32 insertion-order label (-1 free)
    patches: torch.Tensor    # [MF,B,B] u8 stored 11x11 patches
    xp_org: torch.Tensor     # [MF,7] camera position at acquisition
    attempts: torch.Tensor   # [MF] i32 attempted measurements
    successes: torch.Tensor  # [MF] i32 successful measurements
    # per-slot patch row read by the search kernel: lanes 0..B*B-1 = pixels
    # (f32, row-major), B*B = sum, B*B+1 = sum of squares
    patch_rows: torch.Tensor  # [MF,128] f32
    # partial-feature particle filter (per slot; only meaningful when !full)
    lam: torch.Tensor            # [MF,NP] depth hypotheses
    prob: torch.Tensor           # [MF,NP] particle probabilities
    palive: torch.Tensor         # [MF,NP] bool
    match_attempts: torch.Tensor  # [MF] i32
    # Feature::scheduled_for_termination_flag_ (feature.h:134), persistent
    # across frames (the exterminate iterator skip, docs/PARITY.md)
    sched: torch.Tensor          # [MF] bool
    # misc
    rng: torch.Tensor        # [3] i32: 16-bit limbs of the drand48 state
    next_label: torch.Tensor  # [] i32
    frame_no: torch.Tensor   # [] i32


def patch_row(patch_u8: torch.Tensor) -> torch.Tensor:
    """[..., 128] f32 row for each [..., B, B] patch: pixels | sum | sum of
    squares (integer sums are exact in f32 for 11x11 u8 patches)."""
    B = patch_u8.shape[-1]
    lead = patch_u8.shape[:-2]
    p32 = patch_u8.to(torch.int32)
    row = torch.zeros((*lead, 128), dtype=torch.float32, device=patch_u8.device)
    row[..., : B * B] = patch_u8.reshape(*lead, -1).to(torch.float32)
    row[..., B * B] = p32.sum(dim=(-2, -1)).to(torch.float32)
    row[..., B * B + 1] = (p32 * p32).sum(dim=(-2, -1)).to(torch.float32)
    return row


def slot_offset(i):
    return CAM_DIM + SLOT_DIM * i


def init_state(params: Params, xv0, pxx0, seed: int = 0, *, device, dtype) -> SlamState:
    MF, NP, B = params.max_features, params.n_particles, params.boxsize
    D = params.state_dim
    kw = dict(device=device)
    x = torch.zeros(D, dtype=dtype, **kw)
    x[:CAM_DIM] = torch.as_tensor(np.asarray(xv0, np.float64), dtype=dtype, device=device)
    P = torch.zeros((D, D), dtype=dtype, **kw)
    P[:CAM_DIM, :CAM_DIM] = torch.as_tensor(np.asarray(pxx0, np.float64), dtype=dtype, device=device)
    return SlamState(
        x=x,
        P=P,
        active=torch.zeros(MF, dtype=torch.bool, **kw),
        full=torch.zeros(MF, dtype=torch.bool, **kw),
        label=torch.full((MF,), -1, dtype=torch.int32, **kw),
        patches=torch.zeros((MF, B, B), dtype=torch.uint8, **kw),
        xp_org=torch.zeros((MF, 7), dtype=dtype, **kw),
        attempts=torch.zeros(MF, dtype=torch.int32, **kw),
        successes=torch.zeros(MF, dtype=torch.int32, **kw),
        patch_rows=torch.zeros((MF, 128), dtype=torch.float32, **kw),
        lam=torch.zeros((MF, NP), dtype=dtype, **kw),
        prob=torch.zeros((MF, NP), dtype=dtype, **kw),
        palive=torch.zeros((MF, NP), dtype=torch.bool, **kw),
        match_attempts=torch.zeros(MF, dtype=torch.int32, **kw),
        sched=torch.zeros(MF, dtype=torch.bool, **kw),
        rng=torch.as_tensor(pack_state(srand48(seed)).astype(np.int32), device=device),
        next_label=torch.zeros((), dtype=torch.int32, **kw),
        frame_no=torch.zeros((), dtype=torch.int32, **kw),
    )


def add_known_feature(state: SlamState, y, xp_org, patch_u8) -> SlamState:
    """Known feature with zero covariance (host-side init path,
    feature.cpp:108-149). Takes the first free slot; raises when full."""
    free = np.flatnonzero(~state.active.cpu().numpy())
    if len(free) == 0:
        raise ValueError("feature capacity exhausted")
    slot = int(free[0])
    dev, dt = state.x.device, state.x.dtype
    off = slot_offset(slot)
    patch = torch.tensor(np.asarray(patch_u8, np.uint8), device=dev)
    x = state.x.clone()
    x[off : off + 3] = torch.as_tensor(np.asarray(y, np.float64), dtype=dt, device=dev)

    def put(arr, val):
        arr = arr.clone()
        arr[slot] = val
        return arr

    return state._replace(
        x=x,
        active=put(state.active, True),
        full=put(state.full, True),
        label=put(state.label, state.next_label),
        patches=put(state.patches, patch),
        patch_rows=put(state.patch_rows, patch_row(patch)),
        xp_org=put(state.xp_org, torch.as_tensor(np.asarray(xp_org, np.float64), dtype=dt, device=dev)),
        next_label=state.next_label + 1,
    )


def init_from_config(cfg: SlamConfig, seed: int = 0, *, device, dtype) -> SlamState:
    state = init_state(cfg.params, cfg.xv0, cfg.pxx0, seed=seed, device=device, dtype=dtype)
    for kf in cfg.known_features:
        state = add_known_feature(state, kf.y, kf.xp_org, read_pgm(kf.patch_path))
    return state


def lambda_grid(params: Params) -> np.ndarray:
    """Initial particle depth grid, with the reference's repeated addition
    (monoslam.cpp:1223-1234: lambda += step in a loop, NOT min + i*step;
    the accumulated rounding is part of the parity surface)."""
    step = (1.0 / float(params.n_particles)) * (params.max_lambda - params.min_lambda)
    vals = np.empty(params.n_particles, np.float64)
    lam = params.min_lambda
    for i in range(params.n_particles):
        vals[i] = lam
        lam += step
    return vals


def free_slot(state: SlamState):
    """Index of the first free slot ([...] int64) and whether one exists."""
    any_free = ~torch.all(state.active, dim=-1)
    slot = torch.argmin(state.active.to(torch.int32), dim=-1)
    return slot, any_free


def has_lanes(state: SlamState) -> bool:
    """Whether every field carries a leading lane dimension."""
    return state.x.dim() == 2


def _as_lane(t: torch.Tensor) -> torch.Tensor:
    return t.unsqueeze(0)


def _slot_dims(slot: torch.Tensor) -> torch.Tensor:
    """[B, 6] state dimensions of slot [B]."""
    return CAM_DIM + SLOT_DIM * slot[:, None] + torch.arange(SLOT_DIM, device=slot.device)


def _read_slot_block(P, idx6):
    """(rows [B, 6, D], pyy [B, 6, 6]) of each lane's slot."""
    bi = torch.arange(P.shape[0], device=P.device)[:, None]
    return P[bi, idx6], P[bi[:, :, None], idx6[:, :, None], idx6[:, None, :]]


def _write_slot_block(P, idx6, rows, pyy):
    """P [B, D, D] with rows [B, 6, D] written at each lane's slot rows,
    their transpose at its columns, then pyy [B, 6, 6] at its diagonal block
    (the JAX package's dynamic_update_slice order)."""
    bi = torch.arange(P.shape[0], device=P.device)[:, None]
    P = P.clone()
    P[bi, idx6] = rows
    P[bi, :, idx6] = rows
    P[bi[:, :, None], idx6[:, :, None], idx6[:, None, :]] = pyy
    return P


def _write_slot_state(x, idx6, vals):
    bi = torch.arange(x.shape[0], device=x.device)[:, None]
    x = x.clone()
    x[bi, idx6] = vals
    return x


def add_partial_feature(state: SlamState, cam: CameraParams, h: torch.Tensor,
                        patch_u8: torch.Tensor, lam0: torch.Tensor,
                        enable: torch.Tensor) -> SlamState:
    """Partial (ray) feature insertion into the first free slot
    (feature.cpp:45-104): the slot's rows of P become J_x P[cam, :] with
    J_x = dypi_by_dxp (the 7 position-state columns), and its diagonal
    block J_x Pxx J_x' + dypi_by_dhi R dypi_by_dhi'.

    A masked no-op when enable is false or no slot is free: every write
    carries the new content or the slot's current content.

    One form serves the single stream and the lane batch: with a lane
    dimension on every field of the state, h is [B, 2], patch_u8 [B, b, b]
    and enable [B], and each lane inserts into its own first free slot (the
    result of the JAX package's onehot=True form under vmap). A state
    without lanes runs as one lane."""
    if not has_lanes(state):
        out = add_partial_feature(SlamState(*map(_as_lane, state)), cam, h[None], patch_u8[None],
                                  lam0, enable[None])
        return SlamState(*(t[0] for t in out))
    slot, any_free = free_slot(state)
    doit = enable & any_free
    idx6 = _slot_dims(slot)
    xp = state.x[:, :7]
    ypi, dxp, dhi = models.part_init_ray(cam, h, xp)
    new_rows = mm_seq(dxp, state.P[:, :7, :])                           # [B, 6, D]
    pyy = (mm_seq(new_rows[..., :7], dxp.mT)
           + mm_seq(mm_seq(dhi, measurement_noise(cam, h)), dhi.mT))
    old_rows, old_pyy = _read_slot_block(state.P, idx6)
    d3 = doit[:, None, None]
    P = _write_slot_block(state.P, idx6, torch.where(d3, new_rows, old_rows),
                          torch.where(d3, pyy, old_pyy))
    bi = torch.arange(state.x.shape[0], device=slot.device)[:, None]
    x = _write_slot_state(state.x, idx6, torch.where(doit[:, None], ypi, state.x[bi, idx6]))

    NP = state.lam.shape[-1]
    MF = state.active.shape[-1]
    put = (torch.arange(MF, device=slot.device) == slot[:, None]) & doit[:, None]   # [B, MF]

    def sel(arr, new):
        """arr [B, MF, ...] with `new` at each lane's slot: a value per lane
        [B, ...] or one shared by all lanes [...]."""
        if new.dim() == arr.dim() - 1:
            new = new.unsqueeze(1)
        return torch.where(put.view(*put.shape, *(1,) * (arr.dim() - 2)), new, arr)

    patch = patch_u8.to(torch.uint8)
    zi = torch.zeros((), dtype=torch.int32, device=slot.device)
    return state._replace(
        x=x,
        P=P,
        active=state.active | put,
        full=state.full & ~put,
        label=sel(state.label, state.next_label),
        patches=sel(state.patches, patch),
        patch_rows=sel(state.patch_rows, patch_row(patch)),
        xp_org=sel(state.xp_org, xp),
        attempts=sel(state.attempts, zi),
        successes=sel(state.successes, zi),
        lam=sel(state.lam, lam0.to(state.lam.dtype)),
        prob=sel(state.prob, torch.full((NP,), 1.0 / NP, dtype=state.prob.dtype, device=slot.device)),
        palive=state.palive | put[:, :, None],
        match_attempts=sel(state.match_attempts, zi),
        sched=state.sched & ~put,
        next_label=state.next_label + doit.to(state.next_label.dtype),
    )


def convert_feature(state: SlamState, slot: torch.Tensor, lam_mean: torch.Tensor,
                    lam_cov: torch.Tensor, enable: torch.Tensor) -> SlamState:
    """Ray -> 3D point conversion (feature.cpp:204-269) on the dense P: the
    slot's rows become T P[slot6, :] with T = dyfi_by_dypi, its diagonal
    block T Pyy T' + b Plambda b', and its last 3 dims are zeroed. A masked
    no-op when enable is false (value-selected writes). With a lane
    dimension on the state, slot, lam_mean, lam_cov and enable are [B] (the
    JAX package's onehot=True form under vmap)."""
    if not has_lanes(state):
        out = convert_feature(SlamState(*map(_as_lane, state)), slot[None], lam_mean[None],
                              lam_cov[None], enable[None])
        return SlamState(*(t[0] for t in out))
    B, D = state.x.shape
    dev = state.x.device
    idx6 = _slot_dims(slot.to(torch.int64))
    bi = torch.arange(B, device=dev)[:, None]
    y6 = state.x[bi, idx6]
    yfi, T, b = models.part_convert_to_full(y6, lam_mean)
    old_rows, old_pyy = _read_slot_block(state.P, idx6)
    rows6 = torch.zeros((B, SLOT_DIM, D), dtype=state.P.dtype, device=dev)
    rows6[:, :3] = mm_seq(T, old_rows)
    pyy6 = torch.zeros((B, SLOT_DIM, SLOT_DIM), dtype=state.P.dtype, device=dev)
    pyy6[:, :3, :3] = (mm_seq(mm_seq(T, old_pyy), T.mT)
                       + mm_seq(mm_seq(b, lam_cov.reshape(B, 1, 1)), b.mT))
    e3 = enable[:, None, None]
    P = _write_slot_block(state.P, idx6, torch.where(e3, rows6, old_rows),
                          torch.where(e3, pyy6, old_pyy))
    x6 = torch.cat([yfi, torch.zeros((B, 3), dtype=state.x.dtype, device=dev)], dim=-1)
    x = _write_slot_state(state.x, idx6, torch.where(enable[:, None], x6, y6))
    hot = (torch.arange(state.full.shape[-1], device=dev) == slot[:, None]) & enable[:, None]
    return state._replace(
        x=x,
        P=P,
        full=state.full | hot,
        palive=state.palive & ~hot[:, :, None],
    )


def delete_mask(state: SlamState, kill: torch.Tensor, zero_xp: bool = True) -> SlamState:
    """Delete all slots where kill[i] (monoslam.cpp:770-812 semantics: the
    feature's covariance rows/cols are zeroed and the slot freed).
    zero_xp=False skips the x/P zeroing when the caller already zeroed them
    (the fused update kernel does). kill is [MF], or [B, MF] on a state with
    lanes."""
    if zero_xp:
        keep_dims = torch.cat([
            torch.ones((*kill.shape[:-1], CAM_DIM), dtype=torch.bool, device=kill.device),
            torch.repeat_interleave(~kill, SLOT_DIM, dim=-1),
        ], dim=-1)
        zero = torch.zeros((), dtype=state.P.dtype, device=kill.device)
        P = torch.where(keep_dims[..., :, None] & keep_dims[..., None, :], state.P, zero)
        x = torch.where(keep_dims, state.x, zero)
    else:
        P = state.P
        x = state.x
    zi = torch.zeros((), dtype=torch.int32, device=kill.device)
    return state._replace(
        x=x,
        P=P,
        active=state.active & ~kill,
        full=state.full & ~kill,
        label=torch.where(kill, torch.full_like(state.label, -1), state.label),
        attempts=torch.where(kill, zi, state.attempts),
        successes=torch.where(kill, zi, state.successes),
        palive=state.palive & ~kill[..., None],
        match_attempts=torch.where(kill, zi, state.match_attempts),
        sched=state.sched & ~kill,
    )


# -------------------- block accessors --------------------


def slot_pxy(P: torch.Tensor, MF: int) -> torch.Tensor:
    """All camera-feature cross blocks: [..., MF, 13, 6]."""
    return (P[..., :CAM_DIM, CAM_DIM:].reshape(*P.shape[:-2], CAM_DIM, MF, SLOT_DIM)
            .transpose(-3, -2))


def slot_pyy(P: torch.Tensor, MF: int) -> torch.Tensor:
    """All feature diagonal blocks: [..., MF, 6, 6]."""
    feat = P[..., CAM_DIM:, CAM_DIM:].reshape(*P.shape[:-2], MF, SLOT_DIM, MF, SLOT_DIM)
    return torch.diagonal(feat, dim1=-4, dim2=-2).movedim(-1, -3)


def slot_states(x: torch.Tensor, MF: int) -> torch.Tensor:
    """All slot state vectors: [..., MF, 6]."""
    return x[..., CAM_DIM:].reshape(*x.shape[:-1], MF, SLOT_DIM)
