"""The per-frame MonoSLAM step, stages 1-8.

Port of scenelib2_tpu/runtime/step.py on its f32 single-stream fast path
(the ``fused_pm``, ``fused_update and fast_kpath``, fast auto-init and
``fused_sb`` branches: step.py:212-260, 345-384, 467-491, 543-755, 891-1154).
Stage order follows MonoSLAM::GoOneStep (reference monoslam.cpp:108-180):

  1+2. EKF predict, measurement prediction, top-NSEL selection    K1
  3.   NSSD elliptical search of the selected features             K2
  4-6. joint update, quaternion-norm transform, bookkeeping,
       deletion, symmetrize                                        K3
  7.   auto-init: region proposal                                  K5
       Shi-Tomasi patch pick                                       K6
       ray insertion (runtime/state.add_partial_feature)
  8.   partial-feature particle predict, search and Bayes update   K4
       ray -> point conversion and kills (state surgery)

The step makes no host synchronisation: data-dependent choices stay masks,
and each kernel wrapper launches on the current stream. Where the JAX step
skips stage 7 or the stage-8 surgery behind a lax.cond on data, this step
runs them every frame with the gate as data: each is an exact no-op when its
gate is false (K5 consumes no draw without an attempt; the state surgery
writes back what it read), so the decisions are the JAX step's. The
enable_mapping gate is a host bool, so with mapping off stage 7 is not run
at all (K5 and K6 do not launch); stage 8 runs on both paths, as in JAX,
since a loaded state may hold partial features.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from scenelib2_torch.config import Params
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.device import resolve_device, resolve_dtype
from scenelib2_torch.kernels.ekf_update import UpdateConsts, joint_update
from scenelib2_torch.kernels.measure import O_H, O_S, O_SINV, MeasureConsts
from scenelib2_torch.kernels.particle import ROW_HU, ROW_HV, ROW_S00, ROW_S01, ROW_S11, pack_rows
from scenelib2_torch.kernels.predict_measure import NEG_SENTINEL, predict_measure
from scenelib2_torch.kernels.propose import ProposeConsts, propose
from scenelib2_torch.kernels.search import SearchConsts, search, search_window_origin
from scenelib2_torch.kernels.search_bayes import SearchBayesConsts, search_bayes
from scenelib2_torch.kernels.shi_tomasi import clamp_region, shi_tomasi
from scenelib2_torch.runtime import state as st
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
    """Flatten StepOutputs into one 1-D float vector (the layout of
    scenelib2_tpu/runtime/step.py::pack_outputs). Lossless: every integer
    field is far below the float mantissa."""
    dt = out.r.dtype
    scal = torch.stack([
        out.speed.to(dt), out.n_visible.to(dt), out.n_selected.to(dt),
        out.n_matched.to(dt), out.n_active.to(dt), out.n_partial.to(dt),
        out.did_init.to(dt), out.did_convert.to(dt), out.n_overflow.to(dt),
    ])
    parts = [
        out.r, out.q, out.xv, scal,
        out.sel_slot.to(dt), out.sel_mask.to(dt),
        out.sel_h.reshape(-1).to(dt), out.sel_S.reshape(-1).to(dt),
        out.sel_z.reshape(-1).to(dt), out.sel_matched.to(dt),
        out.init_box.to(dt),
        out.par_slot.to(dt), out.par_mask.to(dt),
        out.par_h.reshape(-1).to(dt), out.par_sinv.reshape(-1).to(dt),
        out.par_alive.reshape(-1).to(dt),
    ]
    return torch.cat(parts)


def packed_size(nsel: int, maxp: int, npart: int) -> int:
    return 3 + 4 + 13 + 9 + nsel * (1 + 1 + 2 + 4 + 2 + 1) + 2 + maxp * (2 + npart * (2 + 4 + 1))


def unpack_outputs(flat: torch.Tensor, nsel: int, maxp: int = 1, npart: int = 0) -> StepOutputs:
    """Inverse of pack_outputs; works on [K] or stacked [T, K] tensors."""
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


def make_step(params: Params, device=None, precision: str = "f32"):
    """Build step(state, frame_u8, enable_mapping) -> (state', StepOutputs).

    device None means CUDA (raises without a GPU); precision "f32" is the
    fast mode whose kernels this package ports. enable_mapping is a bool:
    False skips stage 7 (auto-initialisation) on the host."""
    device = resolve_device(device)
    dtype = resolve_dtype(precision)
    if dtype != torch.float32:
        raise NotImplementedError(
            "the f64 parity mode of the step is not ported yet (ROADMAP Queue 1 item 7)"
        )
    MF = params.max_features
    NSEL = params.n_features_to_select
    MAXP = max(1, params.max_features_to_init_at_once)
    if MAXP != 1:
        raise NotImplementedError(
            "max_features_to_init_at_once > 1 runs the batch-mode particle kernels, "
            "which are not ported yet (ROADMAP Queue 2)"
        )
    B = params.boxsize
    half = (B - 1) // 2
    W, H = params.cam_width, params.cam_height
    RW, RH = params.init_search_width, params.init_search_height
    cam = CameraParams.from_params(params)
    mc = MeasureConsts.from_params(params)
    sc = SearchConsts.from_params(params)
    uc = UpdateConsts.from_params(params)
    pc = ProposeConsts.from_params(params)
    sbc = SearchBayesConsts.from_params(params)
    kw = dict(device=device)
    lane_nsel = torch.arange(NSEL, dtype=torch.int32, **kw)
    lane_mf = torch.arange(MF, **kw)
    patch_offs = torch.arange(B, **kw) - half
    neg_sentinel = torch.tensor(NEG_SENTINEL, dtype=dtype, **kw)
    dt_t = torch.tensor(params.delta_t, dtype=dtype, **kw)
    lam0 = torch.as_tensor(st.lambda_grid(params), dtype=dtype, device=device)
    no_init = torch.zeros((), dtype=torch.bool, **kw)
    no_box = torch.zeros(2, dtype=torch.int32, **kw)

    def auto_init(mid: SlamState, frame_u8, speed, n_visible):
        """Stage 7: K5's region, K6's patch, the ray insertion."""
        n_partial = (mid.active & ~mid.full).sum().to(torch.int32)
        want_init = ((speed > params.min_speed_for_init)
                     & (n_visible < params.n_features_to_keep_visible)
                     & (n_partial < params.max_features_to_init_at_once))
        region_us, region_vs, any_ok, rng_new = propose(
            mid.x, mid.rng, mid.active & mid.full, want_init, pc)
        ru, rv, ruf, rvf = clamp_region(region_us, region_vs, region_us + RW, region_vs + RH, W, H, B)
        ubest, vbest, evbest = shi_tomasi(frame_u8, ru, rv, ruf, rvf, boxsize=B,
                                          region_w=RW, region_h=RH)
        did_init = any_ok & (evbest > params.init_patch_score_thresh)
        # the patch around the pick (a clamped window, as lax.dynamic_slice)
        pr = torch.clamp(vbest.long() - half, 0, H - B) + half + patch_offs
        pcol = torch.clamp(ubest.long() - half, 0, W - B) + half + patch_offs
        patch = frame_u8[pr[:, None], pcol[None, :]]
        mid = st.add_partial_feature(
            mid._replace(rng=rng_new), cam, torch.stack([ubest, vbest]).to(dtype), patch, lam0,
            did_init)
        init_box = torch.where(want_init, torch.stack([region_us, region_vs]), no_box)
        return mid, did_init, init_box

    def step(state: SlamState, frame_u8: torch.Tensor,
             enable_mapping: bool) -> tuple[SlamState, StepOutputs]:
        prev_r = state.x[0:3]

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
        n_selected = sel_mask.sum().to(torch.int32)
        h_sel = sel[O_H : O_H + 2].T
        S_sel = torch.stack(
            [sel[O_S], sel[O_S + 1], sel[O_S + 1], sel[O_S + 2]], dim=1
        ).reshape(NSEL, 2, 2)
        sinv_abc = sel[O_SINV : O_SINV + 3].T.contiguous()

        # ---- 3. windowed NSSD search (K2) ---------------------------------
        u0, v0, ucen, vcen = search_window_origin(h_sel, params.search_win_radius, W, H, B)
        found, u, v, _best, over = search(
            frame_u8, state.patch_rows[top_idx.long()], u0, v0, ucen, vcen,
            sinv_abc, sel_mask, sc,
        )
        z_sel = torch.stack([u, v], dim=1).to(dtype)
        n_matched = found.sum().to(torch.int32)

        # ---- 4-6. joint update + normalise + bookkeeping + delete (K3) ----
        offs = (CAM_DIM + SLOT_DIM * top_idx).to(torch.int32)
        x, P, attempts, successes, sched_after, kill = joint_update(
            x, P, sel, z_sel, found, offs, state.attempts, state.successes,
            state.sched, state.active, state.label, sel_mask, top_idx, uc,
        )
        mid = state._replace(x=x, P=P, attempts=attempts, successes=successes, sched=sched_after)
        mid = st.delete_mask(mid, kill, zero_xp=False)

        # ---- 7. speed gate + auto-initialisation (K5, K6) -----------------
        vel = (mid.x[0:3] - prev_r) / dt_t
        speed = torch.sqrt(torch.sum(vel * vel))
        if enable_mapping:
            mid, did_init, init_box = auto_init(mid, frame_u8, speed, n_visible)
        else:
            did_init, init_box = no_init, no_box

        # ---- 8. partial-feature particles (K4) + conversion / kill --------
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
        mid = mid._replace(prob=prob, palive=palive, match_attempts=match_attempts)
        mid = st.convert_feature(mid, pidx[0], mean[0], cov[0], convert[0])
        kill_p = ((lane_mf == p64[0]) & (kill_c & pmask)[0]) & mid.active & ~mid.full
        mid = st.delete_mask(mid, kill_p)
        par_h = torch.stack([pred[:, ROW_HU], pred[:, ROW_HV]], dim=-1)
        par_sinv = torch.stack(
            [pred[:, ROW_S00], pred[:, ROW_S01], pred[:, ROW_S01], pred[:, ROW_S11]], dim=-1
        ).reshape(MAXP, -1, 2, 2)

        out = StepOutputs(
            r=mid.x[0:3],
            q=mid.x[3:7],
            xv=mid.x[:CAM_DIM],
            speed=speed,
            n_visible=n_visible,
            n_selected=n_selected,
            n_matched=n_matched,
            n_active=mid.active.sum().to(torch.int32),
            n_partial=(mid.active & ~mid.full).sum().to(torch.int32),
            did_init=did_init,
            did_convert=convert.any(),
            n_overflow=over.sum().to(torch.int32) + n_over_p.sum().to(torch.int32),
            sel_slot=top_idx,
            sel_mask=sel_mask,
            sel_h=h_sel,
            sel_S=S_sel,
            sel_z=z_sel,
            sel_matched=found,
            init_box=init_box,
            par_slot=pidx,
            par_mask=searchable.any(dim=1),
            par_h=par_h,
            par_sinv=par_sinv,
            par_alive=searchable,
        )
        return mid._replace(frame_no=mid.frame_no + 1), out

    return step
