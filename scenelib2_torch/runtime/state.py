"""SlamState: fixed-capacity masked SoA state on one device.

Port of scenelib2_tpu/runtime/state.py. One packed state vector and ONE
dense joint covariance over fixed feature slots:

  x[D], P[D,D] with D = 13 + 6*MAX_F.

Each feature slot owns a fixed 6-wide stride (rays need 6 dims; 3D points
use the first 3 and keep exact zeros in the rest). Insertion order is
tracked by monotone labels. The field layout is the JAX package's, so a
state converts both ways (scenelib2_torch/convert.py); the particle fields
are carried, zero-filled, until the particle stage is ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from scenelib2_torch.config import Params, SlamConfig
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
    """[128] f32 row for one patch: pixels | sum | sum of squares (integer
    sums are exact in f32 for 11x11 u8 patches)."""
    B = patch_u8.shape[-1]
    p32 = patch_u8.to(torch.int32)
    row = torch.zeros(128, dtype=torch.float32, device=patch_u8.device)
    row[: B * B] = patch_u8.reshape(-1).to(torch.float32)
    row[B * B] = p32.sum().to(torch.float32)
    row[B * B + 1] = (p32 * p32).sum().to(torch.float32)
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


def delete_mask(state: SlamState, kill: torch.Tensor, zero_xp: bool = True) -> SlamState:
    """Delete all slots where kill[i] (monoslam.cpp:770-812 semantics: the
    feature's covariance rows/cols are zeroed and the slot freed).
    zero_xp=False skips the x/P zeroing when the caller already zeroed them
    (the fused update kernel does)."""
    if zero_xp:
        keep_dims = torch.cat([
            torch.ones(CAM_DIM, dtype=torch.bool, device=kill.device),
            torch.repeat_interleave(~kill, SLOT_DIM),
        ])
        zero = torch.zeros((), dtype=state.P.dtype, device=kill.device)
        P = torch.where(keep_dims[:, None] & keep_dims[None, :], state.P, zero)
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
        palive=state.palive & ~kill[:, None],
        match_attempts=torch.where(kill, zi, state.match_attempts),
        sched=state.sched & ~kill,
    )


# -------------------- block accessors --------------------


def slot_pxy(P: torch.Tensor, MF: int) -> torch.Tensor:
    """All camera-feature cross blocks: [MF, 13, 6]."""
    return P[:CAM_DIM, CAM_DIM:].reshape(CAM_DIM, MF, SLOT_DIM).permute(1, 0, 2)


def slot_pyy(P: torch.Tensor, MF: int) -> torch.Tensor:
    """All feature diagonal blocks: [MF, 6, 6]."""
    feat = P[CAM_DIM:, CAM_DIM:].reshape(MF, SLOT_DIM, MF, SLOT_DIM)
    idx = torch.arange(MF, device=P.device)
    return feat[idx, :, idx, :]


def slot_states(x: torch.Tensor, MF: int) -> torch.Tensor:
    """All slot state vectors: [MF, 6]."""
    return x[CAM_DIM:].reshape(MF, SLOT_DIM)
