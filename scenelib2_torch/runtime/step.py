"""The per-frame MonoSLAM step, stages 1-8: the single stream (make_step)
and the lane batch (make_batch_step, at the end of this file).

Port of scenelib2_tpu/runtime/step.py on its f32 fast path. The single
stream takes the JAX step's route by state dimension D = 13 + 6 MF
(step.py:207-211, 430-432, 649-652). Up to D = 384 the fused route (the
``fused_pm``, ``fused_update and fast_kpath``, fast auto-init and
``fused_sb`` branches: step.py:212-260, 345-384, 467-491, 543-755,
891-1154). Stage order follows MonoSLAM::GoOneStep (reference
monoslam.cpp:108-180):

  1+2. EKF predict, measurement prediction, top-NSEL selection    K1
  3.   NSSD elliptical search of the selected features             K2
  4-6. joint update, quaternion-norm transform, bookkeeping,
       deletion, symmetrize                                        K3
  7.   auto-init: region proposal                                  K5
       Shi-Tomasi patch pick                                       K6
       ray insertion (runtime/state.add_partial_feature's
       composition in one launch)                                  K17
  8.   partial-feature particle predict, search and Bayes update   K4
       ray -> point conversion and kills (state surgery)

Above D = 384 (62 <= MF <= 128) stages 1-6 take the split route
(make_split_stages, the batch step's code on the state as one lane):
core.ekf.predict, K7 (the chain and the top-k), K2, the dense update with
S inverted by K14; stages 7-8 as above. MF > 128 is refused, as in the JAX
fast step.

With max_features_to_init_at_once (MAXP) above 1 stage 8 on either route
is JAX heavy()'s non-fused arm (step.py:592-608, 916-918, 1017-1026,
1120-1152): make_stage8, the batch default route's stage 8, on the state as
one lane: K9's score maps of the MAXP partial patches, K10's particle rows,
K11's search and Bayes update, then convert_feature for each slot in order
and one delete_mask. K4 (JAX's fused_sb) runs at MAXP = 1 only.

With use_pallas=False the single stream takes the JAX step's pure-XLA
route at every D: the batch step's route "xla" on the state as one lane
(make_step), which launches one kernel, K14, to invert S in stage 4
(JAX: ekf.joint_update(..., pallas_chol=not batch_mode)); the rest is
tensor operations.

precision="f64" is the JAX package's x64 step (its default process), on
the state as one lane too. It branches where the JAX step tests the dtype
(fast_kpath, fast_mode, `x.dtype == float32`): stage 2 is the XLA
per-slot chain, stage 4 factors S unrolled (K14 is f32-only,
core/ekf.py::joint_update), stage 7 rolls forward by ten literal
motion.func_fv steps and picks the patch with the f64 Shi-Tomasi form,
stage 8 runs the reference-order per-slot particle chain, the f64 score
maps, the dense search and the XLA Bayes chain. Only stage 3 follows
use_pallas: with use_pallas=False (the parity route, "xla-f64") the f64
XLA search, so the step launches no kernel at all; with use_pallas=True
(JAX's hybrid route, "k2-f64") K2 on f32 casts of S^-1, as JAX's wrapper
casts them (pallas_search.py:430-437).

The step makes no host synchronisation: data-dependent choices stay masks,
and each kernel wrapper launches on the current stream. Where the JAX step
skips stage 7 or the stage-8 surgery behind a lax.cond on data, this step
runs them every frame with the gate as data: each is an exact no-op when its
gate is false (K5 consumes no draw without an attempt; the state surgery
writes back what it read), or takes the skipped branch's results by a
select (stage 8 above D = 128: lax.cond(making_any, heavy, light)), so the
decisions are the JAX step's. The enable_mapping gate is a host bool, so
with mapping off stage 7 is not run at all (K5, K6 and K17 do not launch); stage
8 runs on both paths, as in JAX, since a loaded state may hold partial
features.

Every route marks where its stages start (runtime/telemetry.py ``stage``:
s1_2, s3, s4_6, s7, s8, tail, the last the outputs' assembly): a mark
counts a graph's kernels by stage while runtime/replay.py captures it and
does nothing otherwise. The split route's update (joint_update, normalise,
symmetrize) is the region ``ekf.update`` (telemetry ``region``), as
core.ekf.predict and mm_seq are theirs.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import torch

from scenelib2_torch.config import Params
from scenelib2_torch.core import camera as cam_mod
from scenelib2_torch.core import ekf, models, motion
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.core.quaternion import (
    mm_seq,
    quat_from_angular_velocity,
    quat_mul,
    quat_to_rotation_matrix,
)
from scenelib2_torch.device import resolve_device, resolve_dtype
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.bayes import bayes_update, bayes_update_xla
from scenelib2_torch.kernels.ekf_update import UpdateConsts, joint_update
from scenelib2_torch.kernels.measure import (
    O_H,
    O_S,
    O_SINV,
    MeasureConsts,
    measure_select,
    stable_top_k,
)
from scenelib2_torch.kernels.particle import (
    ROW_HU,
    ROW_HV,
    ROW_S00,
    ROW_S01,
    ROW_S11,
    pack_rows,
    pack_rows_batch,
    particle_predict,
)
from scenelib2_torch.kernels.particle_search import ParticleSearchConsts, particle_search
from scenelib2_torch.kernels.predict_measure import NEG_SENTINEL, predict_measure
from scenelib2_torch.kernels.propose import REGION_LIM, ProposeConsts, jump_table, propose_region
from scenelib2_torch.kernels.ray_insert import RayInsertConsts, ray_insert
from scenelib2_torch.kernels.score_map import ScoreMapConsts, score_map
from scenelib2_torch.kernels.search import (
    SearchConsts,
    search,
    search_window_origin,
    search_windows,
)
from scenelib2_torch.kernels.search_bayes import SearchBayesConsts, search_bayes, search_bayes_maps
from scenelib2_torch.kernels.shi_tomasi import (
    clamp_region,
    shi_tomasi,
    shi_tomasi_plain,
)
from scenelib2_torch.rng import drand48_many
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime import telemetry
from scenelib2_torch.runtime.state import CAM_DIM, SLOT_DIM, SlamState


class StepOutputs(NamedTuple):
    r: torch.Tensor            # [3] camera position (posterior)
    q: torch.Tensor            # [4] camera quaternion
    xv: torch.Tensor           # [13] full camera state
    speed: torch.Tensor        # [] m/s estimate used for the mapping gate
    n_visible: torch.Tensor    # [] i32
    n_selected: torch.Tensor   # [] i32
    n_matched: torch.Tensor    # [] i32
    n_active: torch.Tensor     # [] i32
    n_partial: torch.Tensor    # [] i32
    did_init: torch.Tensor     # [] bool — new partial feature created
    did_convert: torch.Tensor  # [] bool — some ray became a 3D point
    n_overflow: torch.Tensor   # [] i32 — searches that hit the window cap
    sel_slot: torch.Tensor     # [NSEL] i32 selected slot ids (garbage where !sel)
    sel_mask: torch.Tensor     # [NSEL] bool
    sel_h: torch.Tensor        # [NSEL,2] predicted image positions
    sel_S: torch.Tensor        # [NSEL,2,2] innovation covariances
    sel_z: torch.Tensor        # [NSEL,2] matched pixel (valid where matched)
    sel_matched: torch.Tensor  # [NSEL] bool
    init_box: torch.Tensor     # [2] i32 (us, vs) of the init region
    par_slot: torch.Tensor     # [MAXP] i32 partial slot ids
    par_mask: torch.Tensor     # [MAXP] bool
    par_h: torch.Tensor        # [MAXP,NP,2]
    par_sinv: torch.Tensor     # [MAXP,NP,2,2]
    par_alive: torch.Tensor    # [MAXP,NP] bool


def pack_outputs(out: StepOutputs) -> torch.Tensor:
    """Flatten StepOutputs into one float vector per step (the layout of
    scenelib2_tpu/runtime/step.py::pack_outputs): [K], or [B, K] when the
    fields carry a lane dimension. Lossless: every integer field is far
    below the float mantissa."""
    dt = out.r.dtype
    lead = out.speed.shape
    scal = torch.stack([
        out.speed.to(dt), out.n_visible.to(dt), out.n_selected.to(dt),
        out.n_matched.to(dt), out.n_active.to(dt), out.n_partial.to(dt),
        out.did_init.to(dt), out.did_convert.to(dt), out.n_overflow.to(dt),
    ], dim=-1)

    def flat(t):
        return t.reshape(*lead, -1).to(dt)

    parts = [
        out.r, out.q, out.xv, scal,
        out.sel_slot.to(dt), out.sel_mask.to(dt),
        flat(out.sel_h), flat(out.sel_S), flat(out.sel_z), out.sel_matched.to(dt),
        out.init_box.to(dt),
        out.par_slot.to(dt), out.par_mask.to(dt),
        flat(out.par_h), flat(out.par_sinv), flat(out.par_alive),
    ]
    return torch.cat(parts, dim=-1)


def packed_size(nsel: int, maxp: int, npart: int) -> int:
    return 3 + 4 + 13 + 9 + nsel * (1 + 1 + 2 + 4 + 2 + 1) + 2 + maxp * (2 + npart * (2 + 4 + 1))


def unpack_outputs(flat: torch.Tensor, nsel: int, maxp: int = 1, npart: int = 0) -> StepOutputs:
    """Inverse of pack_outputs; works on [K] or stacked [T, K] or
    [T, B, K] tensors."""
    lead = flat.shape[:-1]
    o = 0

    def take(n, shape=()):
        nonlocal o
        t = flat[..., o : o + n]
        o += n
        return t.reshape(*lead, *shape) if shape else t

    r = take(3)
    q = take(4)
    xv = take(13)
    scal = take(9)
    sel_slot = take(nsel)
    sel_mask = take(nsel)
    sel_h = take(2 * nsel, (nsel, 2))
    sel_S = take(4 * nsel, (nsel, 2, 2))
    sel_z = take(2 * nsel, (nsel, 2))
    sel_matched = take(nsel)
    init_box = take(2)
    par_slot = take(maxp)
    par_mask = take(maxp)
    par_h = take(2 * maxp * npart, (maxp, npart, 2))
    par_sinv = take(4 * maxp * npart, (maxp, npart, 2, 2))
    par_alive = take(maxp * npart, (maxp, npart))
    i32 = torch.int32
    return StepOutputs(
        r=r, q=q, xv=xv,
        speed=scal[..., 0],
        n_visible=scal[..., 1].to(i32),
        n_selected=scal[..., 2].to(i32),
        n_matched=scal[..., 3].to(i32),
        n_active=scal[..., 4].to(i32),
        n_partial=scal[..., 5].to(i32),
        did_init=scal[..., 6] > 0.5,
        did_convert=scal[..., 7] > 0.5,
        n_overflow=scal[..., 8].to(i32),
        sel_slot=sel_slot.to(i32),
        sel_mask=sel_mask > 0.5,
        sel_h=sel_h,
        sel_S=sel_S,
        sel_z=sel_z,
        sel_matched=sel_matched > 0.5,
        init_box=init_box.to(i32),
        par_slot=par_slot.to(i32),
        par_mask=par_mask > 0.5,
        par_h=par_h,
        par_sinv=par_sinv,
        par_alive=par_alive > 0.5,
    )


# the JAX step's routes by state dimension D = 13 + 6 MF
# (scenelib2_tpu/runtime/step.py:207-211, 430-432, 649-652)
FUSED_MAX_D = 384      # K1 and K3 hold P as one zero-padded block of 384 x 384 at most
HEAVY_ALWAYS_MAX_D = 128   # stage 8 runs every frame; above, only when a partial is measurable
MAX_FEATURES = 128     # K7's and K5's slot row (pallas_measure.py:283, step.py:707-708)
# the f64 steps' names by the flags' route (batch_route): stage 3 is the
# only stage that follows them, the XLA search, K2 or K8 (step.py:371-418)
F64_ROUTES = {"xla": "xla-f64", "default": "k2-f64", "sb0": "k2-f64", "bp0": "k8-f64"}


def make_step(params: Params, device=None, precision: str = "f32"):
    """Build step(state, frame_u8, enable_mapping) -> (state', StepOutputs).

    device None means CUDA (raises without a GPU); precision "f32" is the
    fast mode whose kernels this package ports, "f64" the JAX package's
    parity mode (x64 on). enable_mapping is a bool: False skips stage 7
    (auto-initialisation) on the host.

    With use_pallas (the default) the route follows the JAX step's by
    D = 13 + 6 max_features: up to D = 384 the fused route (K1, K2, K3);
    above it the split route of make_split_stages on the state as one lane
    (K7, K2, K14). On both routes stage 7 is K5, K6, K17 (the ray
    insertion in one launch; the facade's manual auto-init too). Stage 8
    runs every frame up to D = 128 and, above, takes the results of JAX's
    `light` branch where no partial feature is measurable. Stage 8 is K4 at max_features_to_init_at_once = 1 and
    make_stage8's K9, K10 and K11 above it. With use_pallas=False, the JAX
    step's pure-XLA route at every D: make_batch_step's route "xla" on the
    state as one lane, with S inverted by K14 (step.route "xla").
    max_features above 128 is refused, as the JAX fast step cannot run it.

    In f64 the step is make_batch_step's f64 step on the state as one lane,
    at any max_features, with JAX's flag semantics: use_pallas=False is the
    parity route "xla-f64" (no kernel), use_pallas=True the hybrid route
    "k2-f64" (K2 in stage 3, everything else in f64 tensor operations)."""
    device = resolve_device(device)
    dtype = resolve_dtype(precision)
    MF = params.max_features
    NSEL = params.n_features_to_select
    MAXP = max(1, params.max_features_to_init_at_once)
    if params.batch_mode:
        raise NotImplementedError(
            "batch_mode=True takes the batch route on states with a lane dimension: "
            "build the step with scenelib2_torch.parallel.mesh.make_batched_step"
        )
    if dtype == torch.float64:
        return _one_lane(_lane_step(params, device, dtype, "default" if params.use_pallas else "xla",
                                    pallas_chol=True))
    if MF > MAX_FEATURES:
        raise NotImplementedError(
            f"max_features = {MF}: the JAX fast step holds at most {MAX_FEATURES} slots "
            "(its measurement kernel asserts MF <= 128, pallas_measure.py:283, and its "
            "init proposal kernel needs it, step.py:707-708), so there is no reference "
            "route to port above that"
        )
    if not params.use_pallas:
        return _one_lane(_lane_step(params, device, dtype, "xla", pallas_chol=True))
    D = CAM_DIM + SLOT_DIM * MF
    fused = D <= FUSED_MAX_D
    heavy_always = D <= HEAVY_ALWAYS_MAX_D
    split = None if fused else make_split_stages(params, device, dtype, pallas_chol=True)
    # MAXP > 1: JAX's heavy() takes its non-fused arm (step.py:592-608,
    # 916-918), the batch default route's stage 8 on the state as one lane
    stage8 = None if MAXP == 1 else make_stage8(params, device, dtype, "default", heavy_always)
    B = params.boxsize
    W, H = params.cam_width, params.cam_height
    RW, RH = params.init_search_width, params.init_search_height
    mc = MeasureConsts.from_params(params)
    sc = SearchConsts.from_params(params)
    uc = UpdateConsts.from_params(params)
    pc = ProposeConsts.from_params(params)
    ric = RayInsertConsts.from_params(params)
    # the facade's manual auto-init: K5's gate (speed, visible count, partial
    # count) can never close
    pc_open = dataclasses.replace(pc, min_speed=-1.0, keep_visible=1 << 30, max_init=1 << 30)
    sbc = SearchBayesConsts.from_params(params)
    kw = dict(device=device)
    lane_nsel = torch.arange(NSEL, dtype=torch.int32, **kw)
    lane_mf = torch.arange(MF, **kw)
    if lane_mf.is_cuda:   # K5's jump table: uploaded now, never in a step
        jump_table(pc.tries, str(lane_mf.device))
    neg_sentinel = torch.tensor(NEG_SENTINEL, dtype=dtype, **kw)
    dt_t = torch.tensor(params.delta_t, dtype=dtype, **kw)
    lam0 = torch.as_tensor(st.lambda_grid(params), dtype=dtype, device=device)
    no_init = torch.zeros((), dtype=torch.bool, **kw)
    no_box = torch.zeros(2, dtype=torch.int32, **kw)
    zero = torch.zeros((), dtype=dtype, **kw)
    zero_count = torch.zeros((), dtype=torch.int32, **kw)

    def auto_init(mid: SlamState, frame_u8, speed, n_visible, consts=pc):
        """Stage 7: K5's region (with the gate of `consts` and the clamp),
        K6's patch, K17's ray insertion."""
        ru, rv, ruf, rvf, any_ok, rng_new, init_box = propose_region(
            mid.x, mid.rng, mid.active, mid.full, speed, n_visible, consts)
        ubest, vbest, evbest = shi_tomasi(frame_u8, ru, rv, ruf, rvf, boxsize=B,
                                          region_w=RW, region_h=RH)
        mid, did_init = ray_insert(mid, frame_u8, ubest, vbest, evbest, any_ok, rng_new, lam0, ric)
        return mid, did_init, init_box

    def fused_stages(state: SlamState, frame_u8):
        """Stages 1-6 of the fused route (D <= 384): K1, K2, K3."""
        # ---- 1. EKF predict + 2. predict measurements + select (K1) -------
        (_meas, sel, x, P, top_idx, top_score, n_visible, pidx, pmask) = predict_measure(
            state.x, state.P, state.xp_org, state.active & state.full,
            state.active & ~state.full, nsel=NSEL, maxp=MAXP, dt=params.delta_t,
            sd_a=params.sd_a, sd_alpha=params.sd_alpha, consts=mc,
        )
        # a pick is real iff its rank is below the visible count AND its
        # score survived the clamp (a visible slot with a NaN score is ranked
        # last while n_visible still counts it); n_visible stays the raw count
        sel_mask = (lane_nsel < n_visible) & (top_score > neg_sentinel)
        h_sel = sel[O_H : O_H + 2].T
        S_sel = torch.stack(
            [sel[O_S], sel[O_S + 1], sel[O_S + 1], sel[O_S + 2]], dim=1
        ).reshape(NSEL, 2, 2)
        sinv_abc = sel[O_SINV : O_SINV + 3].T.contiguous()

        # ---- 3. windowed NSSD search (K2) ---------------------------------
        telemetry.stage("s3")
        u0, v0, ucen, vcen = search_window_origin(h_sel, params.search_win_radius, W, H, B)
        found, u, v, _best, over = search(
            frame_u8, state.patch_rows[top_idx.long()], u0, v0, ucen, vcen,
            sinv_abc, sel_mask, sc,
        )
        z_sel = torch.stack([u, v], dim=1).to(dtype)

        # ---- 4-6. joint update + normalise + bookkeeping + delete (K3) ----
        telemetry.stage("s4_6")
        offs = (CAM_DIM + SLOT_DIM * top_idx).to(torch.int32)
        x, P, attempts, successes, sched_after, kill = joint_update(
            x, P, sel, z_sel, found, offs, state.attempts, state.successes,
            state.sched, state.active, state.label, sel_mask, top_idx, uc,
        )
        mid = state._replace(x=x, P=P, attempts=attempts, successes=successes, sched=sched_after)
        mid = st.delete_mask(mid, kill, zero_xp=False)
        return mid, Selection(
            n_visible=n_visible, n_selected=sel_mask.sum().to(torch.int32),
            n_matched=found.sum().to(torch.int32), top_idx=top_idx, sel_mask=sel_mask,
            h_sel=h_sel, S_sel=S_sel, z_sel=z_sel, found=found, over=over, pidx=pidx,
            pmask=pmask)

    def particles_k4(mid: SlamState, frame_u8, pidx, pmask) -> tuple[SlamState, PartialMatch]:
        """Stage 8 at MAXP = 1 (JAX's fused_sb, step.py:916-1119): K4 on the
        one partial slot, then its conversion or kill. PartialMatch with a
        lane dimension of one."""
        is_partial = mid.active & ~mid.full
        making_all = is_partial & (mid.match_attempts != 0)
        match_attempts = torch.where(is_partial, mid.match_attempts + 1, mid.match_attempts)
        p64 = pidx.long()
        making = pmask & making_all[p64]
        shared, slot_row = pack_rows(mid.x, mid.P, pidx[0])
        (prob, palive, mean, cov, convert, kill_c, n_over_p, _found, _z, _best, pred) = search_bayes(
            frame_u8, mid.prob, mid.lam, mid.palive, making, pmask, match_attempts[p64], pidx,
            mid.patch_rows.index_select(0, p64)[0], shared, slot_row, sbc,
        )
        searchable = mid.palive[p64] & making[:, None]
        if not heavy_always:
            # the JAX step's lax.cond(making_any, heavy, light) as a select:
            # `light` leaves prob / palive alone, converts and kills nothing
            # and reports zero particle rows
            heavy = making_all.any()
            prob = torch.where(heavy, prob, mid.prob)
            palive = torch.where(heavy, palive, mid.palive)
            convert = convert & heavy
            kill_c = kill_c & heavy
            n_over_p = torch.where(heavy, n_over_p, torch.zeros_like(n_over_p))
            searchable = searchable & heavy
            pred = torch.where(heavy, pred, zero)
        mid = mid._replace(prob=prob, palive=palive, match_attempts=match_attempts)
        mid = st.convert_feature(mid, pidx[0], mean[0], cov[0], convert[0])
        kill_p = ((lane_mf == p64[0]) & (kill_c & pmask)[0]) & mid.active & ~mid.full
        mid = st.delete_mask(mid, kill_p)
        par_h = torch.stack([pred[:, ROW_HU], pred[:, ROW_HV]], dim=-1)
        par_sinv = torch.stack(
            [pred[:, ROW_S00], pred[:, ROW_S01], pred[:, ROW_S01], pred[:, ROW_S11]], dim=-1
        ).reshape(MAXP, -1, 2, 2)
        return mid, PartialMatch(did_convert=convert.any()[None],
                                 n_over=n_over_p.sum().to(torch.int32)[None], par_h=par_h[None],
                                 par_sinv=par_sinv[None], par_alive=searchable[None])

    def step(state: SlamState, frame_u8: torch.Tensor,
             enable_mapping: bool) -> tuple[SlamState, StepOutputs]:
        telemetry.stage("s1_2")
        prev_r = state.x[0:3]
        if fused:
            mid, sl = fused_stages(state, frame_u8)
        else:
            mid_b, sl_b = split(SlamState(*(t[None] for t in state)), frame_u8[None])
            mid = SlamState(*(t[0] for t in mid_b))
            sl = Selection(*(t[0] for t in sl_b))
        n_visible, pidx, pmask = sl.n_visible, sl.pidx, sl.pmask

        # ---- 7. speed gate + auto-initialisation (K5, K6) -----------------
        telemetry.stage("s7")
        vel = (mid.x[0:3] - prev_r) / dt_t
        speed = torch.sqrt(torch.sum(vel * vel))
        if enable_mapping:
            mid, did_init, init_box = auto_init(mid, frame_u8, speed, n_visible)
        else:
            did_init, init_box = no_init, no_box

        # ---- 8. partial-feature particles (K4, or K9 K10 K11) + surgery ---
        telemetry.stage("s8")
        if stage8 is None:
            mid, pm = particles_k4(mid, frame_u8, pidx, pmask)
        else:
            mid_b, pm = stage8(SlamState(*(t[None] for t in mid)), frame_u8[None], pidx[None],
                               pmask[None])
            mid = SlamState(*(t[0] for t in mid_b))
        pm = PartialMatch(*(t[0] for t in pm))

        telemetry.stage("tail")
        out = StepOutputs(
            r=mid.x[0:3],
            q=mid.x[3:7],
            xv=mid.x[:CAM_DIM],
            speed=speed,
            n_visible=n_visible,
            n_selected=sl.n_selected,
            n_matched=sl.n_matched,
            n_active=mid.active.sum().to(torch.int32),
            n_partial=(mid.active & ~mid.full).sum().to(torch.int32),
            did_init=did_init,
            did_convert=pm.did_convert,
            n_overflow=sl.over.sum().to(torch.int32) + pm.n_over,
            sel_slot=sl.top_idx,
            sel_mask=sl.sel_mask,
            sel_h=sl.h_sel,
            sel_S=sl.S_sel,
            sel_z=sl.z_sel,
            sel_matched=sl.found,
            init_box=init_box,
            par_slot=pidx,
            par_mask=pm.par_alive.any(dim=1),
            par_h=pm.par_h,
            par_sinv=pm.par_sinv,
            par_alive=pm.par_alive,
        )
        return mid._replace(frame_no=mid.frame_no + 1), out

    def initialise_auto(state: SlamState, frame_u8: torch.Tensor) -> tuple[SlamState, torch.Tensor]:
        """Stage 7 alone with no gate: the facade's manual auto-init, JAX's
        _auto_initialise(..., want_init=True) (scenelib2_tpu/runtime/step.py:698,
        called from slam.py:141-147). K5 with a gate that cannot close (no
        speed, visible-count or partial-count test), K6, then the ray
        insertion. It still refuses for want of room, of a free try or of a
        passing patch score (did_init false), and a full map leaves the
        state as it was (did_init, as JAX's, does not look at the free
        slot). Returns (state, did_init [] bool)."""
        mid, did_init, _box = auto_init(state, frame_u8, zero, zero_count, pc_open)
        return mid, did_init

    step.route = "fused" if fused else "split"
    step.initialise_auto = initialise_auto
    return step


def _one_lane(lane_step):
    """The single-stream step (and its initialise_auto) of a lane step from
    _lane_step: the state and the frame go in as one lane, and the lane
    dimension comes off the results."""
    def lane(state: SlamState) -> SlamState:
        return SlamState(*(t[None] for t in state))

    def unlane(state_b: SlamState) -> SlamState:
        return SlamState(*(t[0] for t in state_b))

    def step(state: SlamState, frame_u8: torch.Tensor,
             enable_mapping: bool) -> tuple[SlamState, StepOutputs]:
        mid, out = lane_step(lane(state), frame_u8[None], enable_mapping)
        return unlane(mid), StepOutputs(*(t[0] for t in out))

    def initialise_auto(state: SlamState, frame_u8: torch.Tensor) -> tuple[SlamState, torch.Tensor]:
        mid, did_init = lane_step.initialise_auto(lane(state), frame_u8[None])
        return unlane(mid), did_init[0]

    step.route = lane_step.route
    step.initialise_auto = initialise_auto
    return step


# ---------------------------------------------------------------------------
# Batch mode: B independent lanes in one step
# ---------------------------------------------------------------------------


def _lane_gather(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t [B, MF, ...] at idx [B, K] (int64) along the slot dimension -> [B, K, ...]."""
    bi = torch.arange(t.shape[0], device=t.device)[:, None]
    return t[bi, idx]


def _trunc_i32(v: torch.Tensor) -> torch.Tensor:
    """trunc to int32; a non-finite value converts as 0 and the range is
    clamped first, so the conversion is the same on every device."""
    return torch.nan_to_num(torch.trunc(v), nan=0.0).clamp(-REGION_LIM, REGION_LIM).to(torch.int32)


class Selection(NamedTuple):
    """What stages 1-6 hand on to stages 7-8 and the outputs: with a lane
    dimension [B, ...] from make_split_stages, without one on the single
    stream's fused route."""
    n_visible: torch.Tensor    # [B] i32
    n_selected: torch.Tensor   # [B] i32
    n_matched: torch.Tensor    # [B] i32
    top_idx: torch.Tensor      # [B, NSEL] i32
    sel_mask: torch.Tensor     # [B, NSEL] bool
    h_sel: torch.Tensor        # [B, NSEL, 2]
    S_sel: torch.Tensor        # [B, NSEL, 2, 2]
    z_sel: torch.Tensor        # [B, NSEL, 2]
    found: torch.Tensor        # [B, NSEL] bool
    over: torch.Tensor         # [B, NSEL] bool
    pidx: torch.Tensor         # [B, MAXP] i32 partial slots at the start of the frame
    pmask: torch.Tensor        # [B, MAXP] bool


def make_split_stages(params: Params, device, dtype, pallas_chol: bool, route: str = "default"):
    """Stages 1-6 of the split route on states with a lane dimension:
    stages(state_b, frames_b [B, H, W]) -> (state_b after stage 6,
    Selection).

    The route (batch_route's names) picks stages 2 and 3 as the JAX step's
    routes do. Stage 2 is K7, or on routes bp0 and xla, and on every route
    in f64, the XLA per-slot chain of core.models,
    core.camera.measurement_noise and core.ekf.inv2x2_via_chol (JAX
    step.py:305-342). Stage 3 is K2 on the frame; on bp0 K8 on windows
    gathered by correlate.gather_windows_u8 and the stored u8 patches (JAX
    step.py:385-403); on xla the pure-XLA route's tensor operations (JAX
    step.py:404-418: correlate.frame_sums, cross_sum_windows on the stored
    patches, patch_stats, elliptical_search_batch), in the step's dtype. In
    f64 K2 and K8 take S^-1 cast to f32, and K8 the centres floor(h + 0.5)
    cast to f32, as JAX's wrappers pass them (pallas_search.py:290-296,
    430-437).

    The JAX step's route where neither fused kernel applies
    (scenelib2_tpu/runtime/step.py:261-304, 351-384, 434-465, 492-540):
    core.ekf.predict; K7, one launch from x and P in place: the per-slot
    measurement chain, the stable top-NSEL selection (sel_mask = top score
    > -inf, as JAX's batch step) and n_visible from the visibility row; the
    partial slots by top-k over the partial flags; K2; the bookkeeping
    closed form; H, R and nu as dense matrices;
    core.ekf.joint_update, normalise, the any-success gate, delete_mask with
    x and P zeroed, symmetrize. The batch step runs it with
    pallas_chol=False (JAX: pallas_chol=not batch_mode); the single-stream
    step above D = 384 runs it on its state as one lane with pallas_chol=True,
    so S is inverted by K14 (in f32; f64 factors unrolled, as JAX does)."""
    MF = params.max_features
    NSEL = params.n_features_to_select
    MAXP = max(1, params.max_features_to_init_at_once)
    f64 = dtype == torch.float64
    measure_kernel = route not in ("bp0", "xla") and not f64
    if NSEL > MF:
        # JAX's lax.top_k(score, NSEL) refuses this when the step is traced
        raise ValueError(f"n_features_to_select = {NSEL} exceeds max_features = {MF}: the JAX step's "
                         "top-k selection of these routes cannot run it")
    Bx = params.boxsize
    W, H = params.cam_width, params.cam_height
    D = params.state_dim
    mc = MeasureConsts.from_params(params)
    sc = SearchConsts.from_params(params)
    cam = CameraParams.from_params(params)
    kw = dict(device=device)
    pos_mf = torch.arange(MF, dtype=torch.int32, **kw)
    neg_inf = torch.tensor(float("-inf"), dtype=dtype, **kw)
    u_zero = torch.zeros(3, dtype=dtype, **kw)
    inactive_label = torch.tensor(1 << 30, dtype=torch.int32, **kw)
    zero = torch.zeros((), dtype=dtype, **kw)
    one = torch.ones((), dtype=dtype, **kw)

    def bookkeeping(state: SlamState, top64, sel_mask, succ):
        """Stages 5/6 decisions: the counters, the failure-ratio test and the
        closed form of the reference's exterminate loop with its iterator
        skip (in list order, within each run of consecutively scheduled
        positions only the even offsets die this frame)."""
        attempts = state.attempts.scatter_add(1, top64, sel_mask.to(torch.int32))
        successes = state.successes.scatter_add(1, top64, succ.to(torch.int32))
        ratio = torch.where(attempts > 0, successes.to(dtype) / attempts.to(dtype), one)
        bad = (state.active & (attempts >= params.min_attempted_measurements)
               & (ratio < params.successful_match_fraction))
        sched1 = (state.sched | bad) & state.active
        order = torch.argsort(torch.where(state.active, state.label, inactive_label),
                              dim=-1, stable=True)
        S = torch.gather(sched1, 1, order)
        run_start = torch.cummax(torch.where(S, torch.zeros_like(pos_mf), pos_mf + 1), dim=-1).values
        kill_pos = S & ((pos_mf - run_start) % 2 == 0)
        kill = torch.zeros_like(S).scatter(1, order, kill_pos)
        return attempts, successes, kill, sched1 & ~kill

    def stages(state: SlamState, frames: torch.Tensor):
        Bn = state.x.shape[0]

        # ---- 1. EKF predict ------------------------------------------------
        telemetry.stage("s1_2")
        x, P = ekf.predict(state.x, state.P, u_zero, params.delta_t, params.sd_a, params.sd_alpha)

        # ---- 2. predict measurements + select (K7, or the XLA chain) --------
        if measure_kernel:
            (top_idx, top_score, n_visible, h_sel, hx_sel, hy_sel, Rd_sel, S_sel, sinv_abc,
             _rows) = measure_select(x, P, state.xp_org, state.active, state.full, NSEL, mc)
            top64 = top_idx.long()
        else:
            act_full = state.active & state.full
            xp = x[:, None, :7]
            ys3 = st.slot_states(x, MF)[..., :3]
            h_all, hx_all, hy_all, _zeroed = models.full_predict_measurement(cam, ys3, xp)
            R_all = cam_mod.measurement_noise(cam, h_all)
            S_all = models.innovation_covariance(
                P[:, None, :7, :7], st.slot_pxy(P, MF)[..., :7, :3], st.slot_pyy(P, MF)[..., :3, :3],
                hx_all, hy_all, R_all)
            vis = models.full_visibility_test(
                cam, xp, ys3, state.xp_org, h_all, params.image_search_boundary,
                params.max_length_ratio, params.max_angle_difference)
            visible = act_full & (vis == 0)
            n_visible = visible.sum(-1).to(torch.int32)
            top_score, top_idx = stable_top_k(
                torch.where(visible, S_all[..., 0, 0] + S_all[..., 1, 1], neg_inf), NSEL)
            top64 = top_idx.long()
            h_sel = _lane_gather(h_all, top64)
            hx_sel = _lane_gather(hx_all, top64)
            hy_sel = _lane_gather(hy_all, top64)
            Rd_sel = _lane_gather(R_all[..., 0, 0], top64)
            S_sel = _lane_gather(S_all, top64)
            sinv_abc = torch.stack(ekf.inv2x2_via_chol_parts(
                S_sel[..., 0, 0], S_sel[..., 1, 0], S_sel[..., 1, 1]), dim=-1)
        sel_mask = top_score > neg_inf
        # the partial slots as of the start of the frame, lowest slot first
        pvals, pidx = stable_top_k((state.active & ~state.full).to(dtype), MAXP)

        # ---- 3. windowed NSSD search (K2, K8 on gathered windows, or XLA) ---
        telemetry.stage("s3")
        u0, v0, ucen, vcen = search_window_origin(h_sel, params.search_win_radius, W, H, Bx)
        # the kernels take S^-1 in f32 (a no-op cast in the fast mode)
        sinv32 = sinv_abc.to(torch.float32)
        if route == "bp0":
            windows = correlate.gather_windows_u8(frames, u0, v0, params.search_win_radius, Bx)
            # in f64 K8 forms floor(h + 0.5) from JAX's f32 cast of it: the
            # same centre where |h| < 2^23
            h_k8 = torch.floor(h_sel + 0.5).to(torch.float32) if f64 else h_sel
            found, u, v, _best, over = search_windows(
                windows, _lane_gather(state.patches, top64), u0, v0, h_k8, sinv32, sel_mask, sc)
        elif route == "xla":
            patches = _lane_gather(state.patches, top64)
            sg1, sg1sq, _valid = correlate.frame_sums(frames, Bx, dtype)
            cross = correlate.cross_sum_windows(frames, patches, u0, v0, params.search_win_radius, Bx)
            sg0, sg0sq = correlate.patch_stats(patches, dtype)
            found, u, v, _best, over = correlate.elliptical_search_batch(
                sg1, sg1sq, cross, sg0, sg0sq, u0, v0, h_sel, sinv_abc, sel_mask, Bx,
                win_radius=params.search_win_radius, no_sigma=params.no_sigma,
                corr_thresh2=params.corr_thresh2, corr_sigma_thresh=params.corr_sigma_thresh)
        else:
            found, u, v, _best, over = search(
                frames, _lane_gather(state.patch_rows, top64), u0, v0, ucen, vcen, sinv32,
                sel_mask, sc)
        z_sel = torch.stack([u, v], dim=-1).to(dtype)
        nu_sel = torch.where(found[..., None], z_sel - h_sel, zero)
        n_matched = found.sum(-1).to(torch.int32)

        # ---- 4-6. joint update + normalise + bookkeeping + delete -----------
        telemetry.stage("s4_6")
        attempts, successes, kill, sched_after = bookkeeping(state, top64, sel_mask, found)
        offs = CAM_DIM + SLOT_DIM * top64
        f4 = found[:, :, None, None]
        H_rows = torch.zeros((Bn, NSEL, 2, D), dtype=dtype, **kw)
        cols = (offs[:, :, None] + torch.arange(3, **kw))[:, :, None, :].expand(Bn, NSEL, 2, 3)
        H_rows.scatter_(3, cols, torch.where(f4, hy_sel, zero))
        H_rows[..., :7] = torch.where(f4, hx_sel, zero)
        R_tot = torch.diag_embed(torch.where(found, Rd_sel, one).repeat_interleave(2, dim=-1))
        with telemetry.region("ekf.update"):
            x_upd, P_upd, _S = ekf.joint_update(x, P, H_rows.reshape(Bn, 2 * NSEL, D),
                                                nu_sel.reshape(Bn, 2 * NSEL), R_tot,
                                                pallas_chol=pallas_chol)
            x_upd, P_upd = ekf.normalise(x_upd, P_upd)
        any_succ = n_matched > 0
        x = torch.where(any_succ[:, None], x_upd, x)
        P = torch.where(any_succ[:, None, None], P_upd, P)
        mid = state._replace(x=x, P=P, attempts=attempts, successes=successes, sched=sched_after)
        mid = st.delete_mask(mid, kill)
        with telemetry.region("ekf.update"):
            mid = mid._replace(P=ekf.symmetrize(mid.P))
        return mid, Selection(
            n_visible=n_visible, n_selected=sel_mask.sum(-1).to(torch.int32), n_matched=n_matched,
            top_idx=top_idx, sel_mask=sel_mask, h_sel=h_sel, S_sel=S_sel, z_sel=z_sel,
            found=found, over=over, pidx=pidx, pmask=pvals > 0)

    return stages


def batch_route(params: Params, batch_sb: bool | None = None) -> str:
    """The JAX batch route that these flags select: "xla" for
    use_pallas=False (the pure-XLA route, whatever batch_pallas says); "bp0"
    for batch_pallas=False; with batch_pallas=True, "sb0" where the search +
    Bayes pair replaces the fused kernel (batch_sb False, or batch_sb None
    and the environment variable SCENELIB2_BATCH_SB set to "0", which the
    JAX step reads when it is traced, step.py:1061-1062), else "default"."""
    if not params.use_pallas:
        return "xla"
    if not params.batch_pallas:
        return "bp0"
    if batch_sb is None:
        batch_sb = os.environ.get("SCENELIB2_BATCH_SB", "1") != "0"
    return "default" if batch_sb else "sb0"


def slot_predict(cam: CameraParams, xp, Pxx7, ys6, pxy6, pyy6, lam):
    """The per-particle measurement prediction of the JAX step in f64
    (scenelib2_tpu/runtime/step.py:1027-1050), the reference's operation
    order (part_feature_model.cpp:231-265): for every partial slot the ray
    in the robot frame (part_zeroedyi), then for every depth lam the image
    point and its Jacobians (part_predict_from_zeroed), R,
    S = hx7 Pxx7 hx7' + t + t' + hy6 Pyy hy6' + R with t = hx7 Pxy7 hy6',
    its Cholesky inverse and determinant.

    Arguments and returns as kform_predict's; products are left-to-right
    sums."""
    zeroed, dz_by_dxp, dz_by_dyi = models.part_zeroedyi(ys6, xp)
    hpi, hx7, hy6 = models.part_predict_from_zeroed(
        cam, zeroed[..., None, :], dz_by_dxp[..., None, :, :], dz_by_dyi[..., None, :, :], lam)
    R = cam_mod.measurement_noise(cam, hpi)
    t = mm_seq(mm_seq(hx7, pxy6[..., None, :7, :]), hy6.mT)
    S = (mm_seq(mm_seq(hx7, Pxx7[..., None, :, :]), hx7.mT) + t + t.mT
         + mm_seq(mm_seq(hy6, pyy6[..., None, :, :]), hy6.mT) + R)
    sinv = ekf.inv2x2_via_chol(S)
    dets = S[..., 0, 0] * S[..., 1, 1] - S[..., 1, 0] * S[..., 0, 1]
    return hpi, sinv, dets


def kform_predict(cam: CameraParams, xp, Pxx7, ys6, pxy6, pyy6, lam):
    """The per-particle measurement prediction of the JAX batch step's XLA
    K-form chain (scenelib2_tpu/runtime/step.py:964-1015): for every
    partial slot the lambda-independent geometry (part_zeroedyi; C N1', the
    blocks K0, Ksym, K2), then for every depth lam the image point, the
    innovation covariance S = A (K0 + lam Ksym + lam^2 K2) A' + R, its
    Cholesky inverse and determinant.

    xp [B, 1, 7], Pxx7 [B, 1, 7, 7], ys6 [B, F, 6], pxy6 [B, F, 13, 6],
    pyy6 [B, F, 6, 6], lam [B, F, NP]. Returns (hpi [B, F, NP, 2], sinv
    [B, F, NP, 2, 2], dets [B, F, NP]); products are left-to-right sums."""
    zeroed, dz_by_dxp, dz_by_dyi = models.part_zeroedyi(ys6, xp)
    pxy7 = pxy6[..., :7, :]
    C = torch.cat([torch.cat([Pxx7.expand(*pxy7.shape[:-2], 7, 7), pxy7], -1),
                   torch.cat([pxy7.mT, pyy6], -1)], -2)                          # [B, F, 13, 13]
    N1 = torch.cat([dz_by_dxp[..., 0:3, :], dz_by_dyi[..., 0:3, :]], -1)         # [B, F, 3, 13]
    N2 = torch.cat([dz_by_dxp[..., 3:6, :], dz_by_dyi[..., 3:6, :]], -1)
    CN1 = mm_seq(C, N1.mT)
    CN2 = mm_seq(C, N2.mT)
    K0 = mm_seq(N1, CN1)
    K12 = mm_seq(N1, CN2)
    K2 = mm_seq(N2, CN2)
    Ksym = K12 + K12.mT

    lam4 = lam[..., None, None]
    hLR = zeroed[..., None, 0:3] + lam[..., None] * zeroed[..., None, 3:6]        # [B, F, NP, 3]
    hpi = cam_mod.project(cam, hLR)
    A = cam_mod.project_jacobian(cam, hLR)
    Kl = K0[..., None, :, :] + lam4 * Ksym[..., None, :, :] + (lam4 * lam4) * K2[..., None, :, :]
    S = mm_seq(mm_seq(A, Kl), A.mT) + cam_mod.measurement_noise(cam, hpi)
    sinv = ekf.inv2x2_via_chol(S)
    dets = S[..., 0, 0] * S[..., 1, 1] - S[..., 1, 0] * S[..., 0, 1]
    return hpi, sinv, dets


class PartialMatch(NamedTuple):
    """What stage 8 hands on to the outputs, with a lane dimension."""
    did_convert: torch.Tensor  # [B] bool
    n_over: torch.Tensor       # [B] i32 particle searches that hit the window cap
    par_h: torch.Tensor        # [B, MAXP, NP, 2]
    par_sinv: torch.Tensor     # [B, MAXP, NP, 2, 2]
    par_alive: torch.Tensor    # [B, MAXP, NP] bool


def make_stage8(params: Params, device, dtype, route: str, heavy_always: bool = False):
    """Stage 8 on states with a lane dimension: stage8(mid_b, frames_b,
    pidx [B, MAXP] i32, pmask [B, MAXP]) -> (mid_b', PartialMatch).

    The JAX step's _match_partial_features on the compact partial-slot set
    (scenelib2_tpu/runtime/step.py:891-1154, 1156-1311) at any MAXP, on
    `route` (batch_route's names) in `dtype`: the whole-frame score maps of
    the MAXP patches, the particle prediction, search and Bayes update (the
    kernels of make_batch_step's table, or the XLA forms), prob and palive
    scattered back at pidx, convert_feature for each slot j = 0, 1, ... in
    order (the second reads the P the first wrote), then one delete_mask.

    The JAX step's lax.cond(making_any, heavy, light) is a select per lane:
    `light` leaves prob and palive alone, converts and kills nothing and
    reports zero particle rows. heavy_always is the single stream's small
    maps (D <= 128, step.py:649-656), where JAX runs `heavy` every frame."""
    MF = params.max_features
    NP = params.n_particles
    MAXP = max(1, params.max_features_to_init_at_once)
    f64 = dtype == torch.float64
    plain_images = route in ("bp0", "xla") or f64
    Bx = params.boxsize
    W, H = params.cam_width, params.cam_height
    cam = CameraParams.from_params(params)
    smc = ScoreMapConsts.from_params(params)
    sbc = SearchBayesConsts.from_params(params)
    psc = ParticleSearchConsts.from_params(params)
    kw = dict(device=device)
    zero = torch.zeros((), dtype=dtype, **kw)
    workspace: dict[int, torch.Tensor] = {}     # lanes -> the [B, MAXP, H, W] score maps

    def particles(mid: SlamState, frames, p64, making, pmask, searchable, lam_c, prob_c, palive_c, ma_c):
        """Stage 8's kernels on the partial slots' rows: (prob_f, palive_f,
        mean, cov, convert, kill, n_over, hpi [B, F, NP, 2], sinv
        [B, F, NP, 2, 2]) of the route."""
        Bn = mid.x.shape[0]
        ys6 = _lane_gather(st.slot_states(mid.x, MF), p64)
        pxy6 = _lane_gather(st.slot_pxy(mid.P, MF), p64)
        pyy6 = _lane_gather(st.slot_pyy(mid.P, MF), p64)
        if plain_images:
            corr_maps = correlate.score_maps(frames, _lane_gather(mid.patches, p64), Bx,
                                             params.corr_sigma_thresh, params.low_sigma_penalty, dtype)
            # f64: the reference-order chain; f32 (bp0, xla): the K-form
            predict = slot_predict if f64 else kform_predict
            hpi, sinv, dets = predict(cam, mid.x[:, None, :7], mid.P[:, None, :7, :7], ys6, pxy6,
                                      pyy6, lam_c)
            # the single stream's XLA route: in place of JAX's union-box search
            # (bit-equal for the alive particles, correlate.py)
            found, zu, zv, p_over = correlate.multi_ellipse_search_dense(
                corr_maps, hpi, sinv, searchable, win_radius=params.particle_win_radius,
                no_sigma=params.no_sigma, corr_thresh2=params.corr_thresh2)
            z = torch.stack([zu, zv], dim=-1).to(dtype)
            bayes = bayes_update_xla if route == "xla" or f64 else bayes_update
            return (*bayes(prob_c, lam_c, palive_c, found, p_over, z, hpi, sinv, dets, making,
                           pmask, ma_c, sbc.bayes), hpi, sinv)
        if Bn not in workspace:
            workspace[Bn] = torch.empty((Bn, MAXP, H, W), dtype=torch.float32, **kw)
        corr_maps = score_map(frames, _lane_gather(mid.patch_rows, p64), smc, out=workspace[Bn])
        shared, slot_rows = pack_rows_batch(mid.x[:, :7], mid.P[:, :7, :7], ys6, pxy6, pyy6)
        pred = particle_predict(shared, slot_rows, lam_c, sbc.particle)
        pr = pred[..., :NP]
        hpi = torch.stack([pr[:, :, ROW_HU], pr[:, :, ROW_HV]], dim=-1)
        sinv = torch.stack([pr[:, :, ROW_S00], pr[:, :, ROW_S01], pr[:, :, ROW_S01], pr[:, :, ROW_S11]],
                           dim=-1).reshape(Bn, MAXP, NP, 2, 2)
        if route == "sb0":
            found, zu, zv, p_over = particle_search(corr_maps, hpi, sinv, searchable, psc)
            z = torch.stack([zu, zv], dim=-1).to(dtype)
            return (*bayes_update(prob_c, lam_c, palive_c, found, p_over, z, None, None, None, making,
                                  pmask, ma_c, sbc.bayes, pred_rows=pred), hpi, sinv)
        res = search_bayes_maps(corr_maps, pred, prob_c, lam_c, palive_c, making, pmask, ma_c, sbc)
        return (*res[:7], hpi, sinv)

    def stage8(mid: SlamState, frames, pidx, pmask) -> tuple[SlamState, PartialMatch]:
        Bn = mid.x.shape[0]
        p64 = pidx.long()
        is_partial = mid.active & ~mid.full
        making_all = is_partial & (mid.match_attempts != 0)
        match_attempts = torch.where(is_partial, mid.match_attempts + 1, mid.match_attempts)
        making = pmask & torch.gather(making_all, 1, p64)
        lam_c = _lane_gather(mid.lam, p64)
        prob_c = _lane_gather(mid.prob, p64)
        palive_c = _lane_gather(mid.palive, p64)
        searchable = palive_c & making[:, :, None]
        (prob_f, palive_f, mean, cov, convert, kill_c, n_over_p, hpi, sinv) = particles(
            mid, frames, p64, making, pmask, searchable, lam_c, prob_c, palive_c,
            torch.gather(match_attempts, 1, p64))
        if heavy_always:
            heavy = torch.ones((Bn, 1), dtype=torch.bool, **kw)
        else:
            heavy = making_all.any(-1)[:, None]
        convert = convert & heavy
        kill_c = kill_c & pmask & heavy
        h3 = heavy[:, :, None]
        i3 = p64[:, :, None].expand(Bn, MAXP, NP)
        mid = mid._replace(
            prob=mid.prob.scatter(1, i3, torch.where(h3, prob_f, prob_c)),
            palive=mid.palive.scatter(1, i3, torch.where(h3, palive_f, palive_c)),
            match_attempts=match_attempts)
        for j in range(MAXP):
            mid = st.convert_feature(mid, pidx[:, j], mean[:, j], cov[:, j], convert[:, j])
        kill_p = torch.zeros_like(mid.active).scatter(1, p64, kill_c) & mid.active & ~mid.full
        mid = st.delete_mask(mid, kill_p)
        return mid, PartialMatch(
            did_convert=convert.any(-1),
            n_over=torch.where(heavy, n_over_p, torch.zeros_like(n_over_p)).sum(-1).to(torch.int32),
            par_h=torch.where(h3[..., None], hpi, zero),
            par_sinv=torch.where(h3[..., None, None], sinv, zero),
            par_alive=searchable & h3)

    return stage8


def make_batch_step(params: Params, device=None, precision: str = "f32",
                    batch_sb: bool | None = None):
    """Build step(states_b, frames_b, enable_mapping) -> (states_b', StepOutputs)
    for B independent lanes: every field of states_b and of the outputs
    carries a leading lane dimension and frames_b is [B, H, W] u8.

    Port of the JAX step under jax.vmap with batch_mode=True, reached
    through scenelib2_torch.parallel.mesh.make_batched_step. In f32 on the
    route that the flags select as in JAX (batch_route): "default"
    (batch_pallas=True), "sb0" (batch_pallas=True with the search + Bayes
    pair: batch_sb=False, or batch_sb=None and SCENELIB2_BATCH_SB=0 when the
    step is built), "bp0" (batch_pallas=False) or "xla" (use_pallas=False,
    the pure-XLA route: no kernel). Stage by stage:

                                               default  sb0      bp0      xla
      1.   core.ekf.predict as tensor ops      .        .        .        .
      2.   per-slot measurement prediction     K7       K7       XLA chain XLA chain
           stable top-NSEL selection           (K7)     (K7)     measure.stable_top_k
      3.   NSSD search, B x NSEL programs      K2       K2       K8 on    correlate:
                                                                 gathered windowed
                                                                 windows  sums and
                                                                          search
      4-6. bookkeeping closed form, dense H / R assembly,
           core.ekf.joint_update (unrolled factorisation) + normalise,
           delete_mask, symmetrize
      7.   the proposal chain as tensor ops (the XLA form, not K5),
           Shi-Tomasi pick, B regions         K6       K6       XLA form XLA form
           runtime.state.add_partial_feature over lanes
      8.   whole-frame score maps             K9       K9       correlate.score_maps
           particle prediction                 K10      K10      kform_predict
           particle search                     K11      K13      correlate dense
           Bayes update                        (K11)    K12      K12      bayes_update_xla
           convert_feature + delete_mask over lanes

    Stage 8 (make_stage8) takes the max_features_to_init_at_once partial
    slots of every lane at once: the maps [B, MAXP, H, W], the rows
    [B, MAXP, ...]. Every kernel is launched once a frame for all lanes,
    nothing loops over lanes on the host, and the step makes no host
    synchronisation. Both lax.cond gates of the JAX step are selects under
    vmap; here each gated stage runs with its gate as data. enable_mapping
    is a host bool shared by all lanes.

    precision="f64" is the JAX step with x64 on, where everything but
    stage 3 is the f64 XLA form whatever the flags (fast_kpath and
    fast_mode are false): stage 2 the XLA chain, stage 4 unrolled, stage 7
    the ten-step func_fv rollforward and the f64 Shi-Tomasi form, stage 8
    correlate.score_maps in f64, slot_predict, the dense search and
    bayes_update_xla. Stage 3 follows the flags (F64_ROUTES): "xla-f64"
    (use_pallas=False: no kernel), "k2-f64" (batch_pallas=True: K2) or
    "k8-f64" (batch_pallas=False: K8). batch_sb and SCENELIB2_BATCH_SB pick
    only between stage-8 kernels, so in f64 they change nothing, as in
    JAX."""
    device = resolve_device(device)
    dtype = resolve_dtype(precision)
    return _lane_step(params, device, dtype, batch_route(params, batch_sb), pallas_chol=False)


def _lane_step(params: Params, device, dtype, route: str, pallas_chol: bool):
    """The step of make_batch_step on `route` (batch_route's names) in
    `dtype`. S is inverted by K14 where pallas_chol (the single stream's
    pure-XLA route, JAX's pallas_chol=not batch_mode) and S is f32, else by
    the unrolled factorisation. The step also carries
    initialise_auto(states_b, frames_b) -> (states_b, did_init [B]): stage 7
    with no gate, JAX's _auto_initialise(..., want_init=True)."""
    MF = params.max_features
    f64 = dtype == torch.float64
    if MF > MAX_FEATURES and not f64:
        raise NotImplementedError(f"the batch kernels hold MF <= {MAX_FEATURES}, as the JAX fast step does")
    # the routes whose images run as tensor ops (JAX's XLA forms): in f64
    # every route but stage 3
    plain_images = route in ("bp0", "xla") or f64
    Bx = params.boxsize
    half = (Bx - 1) // 2
    W, H = params.cam_width, params.cam_height
    RW, RH = params.init_search_width, params.init_search_height
    tries = params.init_region_tries
    sep = params.feature_separation_min
    dtN = params.init_steps_to_predict * params.delta_t
    cam = CameraParams.from_params(params)
    kw = dict(device=device)
    lane_try = torch.arange(tries, **kw)
    patch_offs = torch.arange(Bx, **kw)
    dt_t = torch.tensor(params.delta_t, dtype=dtype, **kw)
    lam0 = torch.as_tensor(st.lambda_grid(params), dtype=dtype, device=device)
    u_zero = torch.zeros(3, dtype=dtype, **kw)
    st_kw = dict(dtype=dtype) if f64 else {}
    stages_1_to_6 = make_split_stages(params, device, dtype, pallas_chol, route)
    stage8 = make_stage8(params, device, dtype, route)

    def auto_init(mid: SlamState, frames, speed, n_visible, force: bool = False):
        """Stage 7 over lanes: the region proposal chain, the Shi-Tomasi pick
        (K6, or its XLA form on routes bp0 and xla), the ray insertion; each
        an exact no-op in a lane whose gate is false. force opens the gate
        (speed, visible and partial counts) in every lane."""
        Bn = mid.x.shape[0]
        bi = torch.arange(Bn, **kw)
        x = mid.x
        xp = x[:, :7]
        if force:
            want_init = torch.ones(Bn, dtype=torch.bool, **kw)
        else:
            n_partial = (mid.active & ~mid.full).sum(-1).to(torch.int32)
            want_init = ((speed > params.min_speed_for_init)
                         & (n_visible < params.n_features_to_keep_visible)
                         & (n_partial < params.max_features_to_init_at_once))
        if f64:
            # the literal rollforward of N func_fv steps (JAX step.py:776-780)
            xv_fut = x[:, :CAM_DIM]
            for _ in range(params.init_steps_to_predict):
                xv_fut = motion.func_fv(xv_fut, u_zero, params.delta_t)
            yW = (xv_fut[:, 0:3]
                  + quat_to_rotation_matrix(xv_fut[:, 3:7])[:, :, 2] * params.init_depth_hypothesis)
        else:
            # the constant-velocity rollforward collapsed to one step of N dt
            qf = quat_mul(x[:, 3:7], quat_from_angular_velocity(x[:, 10:13] * dtN))
            yW = (x[:, 0:3] + x[:, 7:10] * dtN
                  + quat_to_rotation_matrix(qf)[:, :, 2] * params.init_depth_hypothesis)
        hi_fut, _ = models.full_project(cam, yW, xp)
        pm_u = W / 2.0 - hi_fut[:, 0]
        pm_v = H / 2.0 - hi_fut[:, 1]
        lo = half + 1
        safe_us = torch.clamp(_trunc_i32(-pm_u), min=lo)
        safe_uf = torch.clamp(_trunc_i32(W - pm_u), max=W - half - 1)
        safe_vs = torch.clamp(_trunc_i32(-pm_v), min=lo)
        safe_vf = torch.clamp(_trunc_i32(H - pm_v), max=H - half - 1)
        room = (safe_uf - safe_us > RW) & (safe_vf - safe_vs > RH)
        # current projections of the fully initialised features
        h_now, zeroed = models.full_project(cam, st.slot_states(x, MF)[..., :3], xp[:, None, :])
        occupied = mid.active & mid.full & (zeroed[..., 2] > 0)
        # up to `tries` random regions, two drand48 draws each
        states_r, vals_r = drand48_many(mid.rng, 2 * tries, dtype=dtype)
        u_off = _trunc_i32((safe_uf - safe_us - RW).to(dtype)[:, None] * vals_r[:, 0::2])
        v_off = _trunc_i32((safe_vf - safe_vs - RH).to(dtype)[:, None] * vals_r[:, 1::2])
        us_all = safe_us[:, None] + u_off                              # [B, tries]
        vs_all = safe_vs[:, None] + v_off
        hu, hv = h_now[:, None, :, 0], h_now[:, None, :, 1]           # [B, 1, MF]
        clash = (occupied[:, None, :]
                 & (hu >= (us_all - sep).to(dtype)[:, :, None])
                 & (hu < (us_all + RW + sep).to(dtype)[:, :, None])
                 & (hv >= (vs_all - sep).to(dtype)[:, :, None])
                 & (hv < (vs_all + RH + sep).to(dtype)[:, :, None])).any(-1)
        ok_all = ~clash
        some_ok = ok_all.any(-1)
        attempt = want_init & room
        any_ok = some_ok & attempt
        first_ok = torch.where(ok_all, lane_try, tries).min(-1).values % tries   # 0 when none
        consumed = torch.where(attempt, torch.where(some_ok, 2 * (first_ok + 1), 2 * tries), 0)
        picked = states_r[bi, torch.clamp(consumed - 1, min=0)]
        rng_new = torch.where((consumed == 0)[:, None], mid.rng, picked)
        region_us = us_all[bi, first_ok]
        region_vs = vs_all[bi, first_ok]

        ru, rv, ruf, rvf = clamp_region(region_us, region_vs, region_us + RW, region_vs + RH, W, H, Bx)
        # the XLA route's Shi-Tomasi (JAX find_best_patch_in_image_window)
        # has K6's plain operation order, so it is shi_tomasi_plain over
        # lanes, its eigenvalues in f64 in the f64 step
        pick_patch = shi_tomasi_plain if plain_images else shi_tomasi
        ubest, vbest, evbest = pick_patch(frames, ru, rv, ruf, rvf, boxsize=Bx,
                                          region_w=RW, region_h=RH, **st_kw)
        did_init = any_ok & (evbest > params.init_patch_score_thresh)
        # the patch around the pick (a clamped window, as lax.dynamic_slice)
        pr = torch.clamp(vbest.long() - half, 0, H - Bx)[:, None] + patch_offs
        pcol = torch.clamp(ubest.long() - half, 0, W - Bx)[:, None] + patch_offs
        patch = frames[bi[:, None, None], pr[:, :, None], pcol[:, None, :]]
        mid = st.add_partial_feature(
            mid._replace(rng=rng_new), cam, torch.stack([ubest, vbest], dim=-1).to(dtype), patch,
            lam0, did_init)
        init_box = torch.where(want_init[:, None], torch.stack([region_us, region_vs], dim=-1),
                               torch.zeros_like(region_us)[:, None])
        return mid, did_init, init_box

    def step(state: SlamState, frames: torch.Tensor,
             enable_mapping: bool) -> tuple[SlamState, StepOutputs]:
        if not st.has_lanes(state) or frames.dim() != 3 or frames.shape[0] != state.x.shape[0]:
            raise ValueError("the batch step takes states with a lane dimension and frames [B, H, W]")
        Bn = state.x.shape[0]
        prev_r = state.x[:, 0:3]

        # ---- 1-6. predict, measure + select, search, update + bookkeeping ---
        mid, sl = stages_1_to_6(state, frames)
        n_visible, pidx, pmask = sl.n_visible, sl.pidx, sl.pmask

        # ---- 7. speed gate + auto-initialisation ----------------------------
        telemetry.stage("s7")
        vel = (mid.x[:, 0:3] - prev_r) / dt_t
        speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
        if enable_mapping:
            mid, did_init, init_box = auto_init(mid, frames, speed, n_visible)
        else:
            did_init = torch.zeros(Bn, dtype=torch.bool, **kw)
            init_box = torch.zeros((Bn, 2), dtype=torch.int32, **kw)

        # ---- 8. partial-feature particles (route's kernels) + surgery ---------
        telemetry.stage("s8")
        mid, pm = stage8(mid, frames, pidx, pmask)

        telemetry.stage("tail")
        out = StepOutputs(
            r=mid.x[:, 0:3],
            q=mid.x[:, 3:7],
            xv=mid.x[:, :CAM_DIM],
            speed=speed,
            n_visible=n_visible,
            n_selected=sl.n_selected,
            n_matched=sl.n_matched,
            n_active=mid.active.sum(-1).to(torch.int32),
            n_partial=(mid.active & ~mid.full).sum(-1).to(torch.int32),
            did_init=did_init,
            did_convert=pm.did_convert,
            n_overflow=sl.over.sum(-1).to(torch.int32) + pm.n_over,
            sel_slot=sl.top_idx,
            sel_mask=sl.sel_mask,
            sel_h=sl.h_sel,
            sel_S=sl.S_sel,
            sel_z=sl.z_sel,
            sel_matched=sl.found,
            init_box=init_box,
            par_slot=pidx,
            par_mask=pm.par_alive.any(dim=-1),
            par_h=pm.par_h,
            par_sinv=pm.par_sinv,
            par_alive=pm.par_alive,
        )
        return mid._replace(frame_no=mid.frame_no + 1), out

    def initialise_auto(states: SlamState, frames: torch.Tensor) -> tuple[SlamState, torch.Tensor]:
        mid, did_init, _box = auto_init(states, frames, None, None, force=True)
        return mid, did_init

    step.route = F64_ROUTES[route] if f64 else route
    step.initialise_auto = initialise_auto
    step.graphs = {}   # parallel.mesh.run_batch's CUDA graphs of this step (runtime/replay.py)
    return step
