"""K17: stage 7's ray insertion in one launch (kernels/ray_insert.py,
csrc/ray_insert.cu), after K5's region and K6's pick.

Held here on the CPU, exactly (integers, masks and floats bit for bit,
NaN equal to NaN):
  - ray_insert's CPU dispatch against the composition the step ran before
    K17 (the init decision, the clamped crop, state.add_partial_feature with
    K5's limbs), on the stage-7 inputs of the port's CPU replay of the std
    sequence and on variations of them;
  - a float32 mirror of the kernel's scalar chain (ray_chain, written as
    the CUDA source is, one NumPy float32 operation each) against the
    twin's tensors: the ray, dypi_by_dxp, the block's dhi R dhi' term, and
    the new rows and block they make;
  - a mirror of the kernel's writes (each CTA's band of rows of P outside
    the slot's rows, after the barrier the slot's columns in the band's
    rows, its rows at the band's columns and the block; x at the band; the
    per-slot fields as selects at the first free slot, found as the lanes'
    minimum) against add_partial_feature, which writes rows, then columns,
    then the block: on an asymmetric P with the gate open and shut, the
    free slot at 0, in the middle and at MF - 1, a full map, at band widths
    from 1 row to K17_MAX_ROWS; no element is written by two CTAs, and each
    is written;
  - the sizes and layouts the wrapper shares with the source (defines, the
    parameter and pointer structs' fields in order).

The tests marked `chip` need a card (each skips without one) and hold the
kernel against its twin on the card, every field bit for bit: on every
stage-7 input of the std 239-frame replay, on a stage-7 input each of the
hires (D = 373) and mf100 (D = 613) streams, on a shut gate over a P made
slightly asymmetric, a full map and the free slot at 0 and at MF - 1; and
the std replay's packed rows with K17 against the same replay with the
twin in its place. Run them on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_k17_int.py -m chip
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import re

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.core import models
from scenelib2_torch.core.camera import CameraParams, measurement_noise
from scenelib2_torch.core.quaternion import mm_seq
from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS, generate_dataset
from scenelib2_torch.kernels import ray_insert as k17
from scenelib2_torch.kernels.ray_insert import RayInsertConsts, ray_insert, ray_insert_plain
from scenelib2_torch.runtime import state as st
from scenelib2_torch.runtime.state import CAM_DIM, SLOT_DIM, SlamState

CSRC = os.path.join(os.path.dirname(k17.__file__), "csrc", "ray_insert.cu")
P_STD = Params()
RIC = RayInsertConsts.from_params(P_STD)
f32 = np.float32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _capture(store: list):
    """Record the arguments of every ray_insert call the step makes."""
    import scenelib2_torch.runtime.step as step_mod

    orig = step_mod.ray_insert

    def call(*a, **k):
        store.append(a)
        return orig(*a, **k)

    step_mod.ray_insert = call
    try:
        yield
    finally:
        step_mod.ray_insert = orig


def _replay_inputs(tmp, device: str, n_frames: int, params=None, **overrides) -> list:
    frames, _, _, cfg = generate_dataset(str(tmp), n_frames=n_frames, seed=7, params=params)
    slam = MonoSLAM(cfg, device=device, **overrides)
    store = []
    with _capture(store):
        for t in range(1, n_frames):
            slam._go_one_step_eager(frames[t])
    return store


@pytest.fixture(scope="module")
def cpu_inputs(tmp_path_factory):
    """ray_insert's inputs on the first 11 output indices of the port's
    CPU replay of the std sequence, mapping on (the first init at 9)."""
    return _replay_inputs(tmp_path_factory.mktemp("std"), "cpu", 12, max_features=16)


def _old_composition(state, frame_u8, ubest, vbest, evbest, any_ok, rng_new, lam0, p: Params):
    """Stage 7 after K6 as make_step's auto_init ran it before K17."""
    B = p.boxsize
    half = (B - 1) // 2
    W, H = p.cam_width, p.cam_height
    patch_offs = torch.arange(B) - half
    did_init = any_ok & (evbest > p.init_patch_score_thresh)
    pr = torch.clamp(vbest.long() - half, 0, H - B) + half + patch_offs
    pcol = torch.clamp(ubest.long() - half, 0, W - B) + half + patch_offs
    patch = frame_u8[pr[:, None], pcol[None, :]]
    mid = st.add_partial_feature(state._replace(rng=rng_new), CameraParams.from_params(p),
                                 torch.stack([ubest, vbest]).to(state.x.dtype), patch, lam0, did_init)
    return mid, did_init


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN equal to NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        na, nb = torch.isnan(a), torch.isnan(b)
        return bool(torch.equal(na, nb) and torch.equal(torch.where(na, 0, a).view(torch.int32),
                                                        torch.where(nb, 0, b).view(torch.int32)))
    return bool(torch.equal(a, b))


def assert_same_state(got, want, what: str):
    for name, a, b in zip(SlamState._fields, got, want):
        assert same(a, b), f"{what}: {name} differs"


def asymmetric(P: torch.Tensor, seed: int, scale: float = 1e-3) -> torch.Tensor:
    """P with seeded noise added above the diagonal only."""
    g = torch.Generator().manual_seed(seed)
    noise = torch.randn(P.shape, generator=g, dtype=P.dtype) * scale
    return P + torch.triu(noise, 1)


def variation(args: tuple, case: str, seed: int = 0) -> tuple:
    """A stage-7 input varied: the gate shut or opened, P asymmetric, the
    map full, the free slot at 0 or at MF - 1."""
    state, frame, ub, vb, ev, ok, rng_new, lam0, c = args
    MF = state.active.shape[0]
    if case in ("shut_asym", "open_asym"):
        state = state._replace(P=asymmetric(state.P, seed))
        ok = torch.tensor(case == "open_asym", device=ok.device)
        ev = torch.full_like(ev, c.thresh * 2.0 + 1.0) if case == "open_asym" else ev
    elif case == "full":
        state = state._replace(active=torch.ones_like(state.active))
        ok = torch.ones_like(ok)
        ev = torch.full_like(ev, c.thresh * 2.0 + 1.0)
    elif case in ("slot0", "slot_last"):
        active = torch.ones_like(state.active)
        active[0 if case == "slot0" else MF - 1] = False
        state = state._replace(active=active, P=asymmetric(state.P, seed))
        ok = torch.ones_like(ok)
        ev = torch.full_like(ev, c.thresh * 2.0 + 1.0)
    elif case == "score_at_thresh":
        ok = torch.ones_like(ok)
        ev = torch.full_like(ev, c.thresh)
    return state, frame, ub, vb, ev, ok, rng_new, lam0, c


CASES = ("real", "shut_asym", "open_asym", "full", "slot0", "slot_last", "score_at_thresh")


# ------------------------------------------------------------------ the CPU dispatch


@pytest.mark.parametrize("case", CASES)
def test_cpu_dispatch_equals_the_old_composition(cpu_inputs, case):
    """ray_insert on CPU tensors is the composition make_step ran before
    K17, bit for bit, on every captured frame."""
    assert any(bool(a[5]) and float(a[4]) > RIC.thresh for a in cpu_inputs), "no init in the replay"
    for t, a in enumerate(cpu_inputs):
        v = variation(a, case, seed=t)
        got, did = ray_insert(*v)
        want, want_did = _old_composition(*v[:8], P_STD)
        assert same(did, want_did), (case, t)
        assert_same_state(got, want, f"{case} frame {t}")


def test_cpu_dispatch_keeps_its_inputs(cpu_inputs):
    """No input is written; rng is K5's tensor and frame_no the state's."""
    a = cpu_inputs[-1]
    before = [t.clone() for t in a[0]]
    out, _ = ray_insert(*a)
    assert_same_state(a[0], SlamState(*before), "inputs")
    assert out.rng.data_ptr() == a[6].data_ptr() and out.frame_no.data_ptr() == a[0].frame_no.data_ptr()


ROUTES = {   # route -> (MonoSLAM arguments, whether K5, K6 and K17 run)
    "fused": (dict(max_features=16), True),
    "split": (dict(max_features=62), True),
    "xla": (dict(max_features=16, use_pallas=False), False),
    "f64": (dict(max_features=16, precision="f64"), False),
}


@contextlib.contextmanager
def _count(counts: dict):
    """Count the step's calls of ray_insert and propose_region, and the
    outermost calls of state.add_partial_feature (the twin's included; a
    state without lanes calls it again as one lane)."""
    import scenelib2_torch.runtime.step as step_mod

    mods = {"ray_insert": step_mod, "propose_region": step_mod, "add_partial_feature": st}
    orig = {n: getattr(m, n) for n, m in mods.items()}
    inside = set()

    def wrap(n):
        def call(*a, **k):
            if n in inside:
                return orig[n](*a, **k)
            counts[n] = counts.get(n, 0) + 1
            inside.add(n)
            try:
                return orig[n](*a, **k)
            finally:
                inside.discard(n)
        return call

    for n, m in mods.items():
        setattr(m, n, wrap(n))
    try:
        yield
    finally:
        for n, m in mods.items():
            setattr(m, n, orig[n])


@pytest.fixture(scope="module")
def std_cfg(tmp_path_factory):
    frames, _, _, cfg = generate_dataset(str(tmp_path_factory.mktemp("std4")), n_frames=4, seed=7)
    return frames, cfg


@pytest.mark.parametrize("route", list(ROUTES))
def test_k17_runs_where_k5_and_k6_run(std_cfg, route):
    """The single stream's kernel routes take the insertion through
    ray_insert (its twin on the CPU) with K5; the pure-XLA and f64 steps
    call state.add_partial_feature themselves and never ray_insert."""
    frames, cfg = std_cfg
    kw, kernels = ROUTES[route]
    slam = MonoSLAM(cfg, device="cpu", **kw)
    counts = {}
    with _count(counts):
        slam.run_sequence(frames[1:4], enable_mapping=True)
    assert counts.get("add_partial_feature", 0) == 3
    assert counts.get("ray_insert", 0) == counts.get("propose_region", 0) == (3 if kernels else 0)
    counts.clear()
    with _count(counts):
        slam.initialise_auto_feature(frames[3])                   # the facade's manual auto-init
        slam.initialise_feature(frames[3], 100, 100)              # the facade's host-side insertion
    assert counts.get("add_partial_feature", 0) == 2
    assert counts.get("ray_insert", 0) == counts.get("propose_region", 0) == (1 if kernels else 0)


def test_batch_step_keeps_add_partial_feature(std_cfg):
    from scenelib2_torch.parallel.mesh import make_batched_step

    frames, cfg = std_cfg
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    step = make_batched_step(slam.params, device="cpu")
    states = SlamState(*(t[None].repeat(2, *([1] * t.dim())) for t in slam.state))
    counts = {}
    with _count(counts):
        for t in range(1, 3):
            states, _ = step(states, torch.as_tensor(np.stack([frames[t]] * 2)), True)
    assert counts.get("add_partial_feature", 0) == 2 and "ray_insert" not in counts


# ------------------------------------------------------------------ the kernel's scalar chain


def chain_mirror(c: RayInsertConsts, u: int, v: int, xp: np.ndarray):
    """csrc/ray_insert.cu's ray_chain in NumPy float32, operation for
    operation: (dxp [6, 7], T2 [6, 6], ypi [6]) from the pick (u, v) and the
    pose xp [7]."""
    cam = c.cam
    u0, v0, neg_fku, neg_fkv = f32(cam.u0), f32(cam.v0), f32(-cam.fku), f32(-cam.fkv)
    two_kd1, pa, pb, sd = f32(2.0 * cam.kd1), f32(-1.0 / cam.fku), f32(-1.0 / cam.fkv), f32(cam.sd)
    one, two, zero = f32(1.0), f32(2.0), f32(0.0)
    c0, c1 = f32(u) - u0, f32(v) - v0
    radius2 = c0 * c0 + c1 * c1
    distor = one - radius2 * two_kd1
    factor = np.sqrt(distor)
    vv = [c0 / factor / neg_fku, c1 / factor / neg_fkv, one]
    qq = (vv[0] * vv[0] + vv[1] * vv[1]) + vv[2] * vv[2]
    norm = np.sqrt(qq)
    a0, a1, a2 = (vv[i] / norm for i in range(3))
    w, x, y, z = (f32(xp[i]) for i in range(3, 7))
    wx, wy, wz = two * w * x, two * w * y, two * w * z
    xx, xy, xz = two * x * x, two * x * y, two * x * z
    yy, yz, zz = two * y * y, two * y * z, two * z * z
    R = [[one - (yy + zz), xy - wz, xz + wy], [xy + wz, one - (xx + zz), yz - wx],
         [xz - wy, yz + wx, one - (xx + yy)]]
    ypi = [f32(xp[0]), f32(xp[1]), f32(xp[2])] + [(R[i][0] * a0 + R[i][1] * a1) + R[i][2] * a2 for i in range(3)]
    dq = [[two * (w * a0 - z * a1 + y * a2), two * (x * a0 + y * a1 + z * a2),
           two * (-y * a0 + x * a1 + w * a2), two * (-z * a0 - w * a1 + x * a2)],
          [two * (z * a0 + w * a1 - x * a2), two * (y * a0 - x * a1 - w * a2),
           two * (x * a0 + y * a1 + z * a2), two * (w * a0 - z * a1 + y * a2)],
          [two * (-y * a0 + x * a1 + w * a2), two * (z * a0 + w * a1 - x * a2),
           two * (-w * a0 + z * a1 - y * a2), two * (x * a0 + y * a1 + z * a2)]]
    dxp = np.zeros((6, 7), f32)
    for i in range(3):
        dxp[i, i] = one
        for k in range(4):
            dxp[3 + i, 3 + k] = dq[i][k]
    N = [[(one - vv[i] * vv[i] / (qq * qq)) / qq if i == j else -(vv[i] * vv[j]) / (qq * qq * qq)
          for j in range(3)] for i in range(3)]
    distor3_2 = factor * distor
    g = two_kd1 / distor3_2
    inv = one / factor
    UJ = [[pa * (c0 * c0 * g + inv), pa * (c0 * c1 * g)], [pb * (c1 * c0 * g), pb * (c1 * c1 * g + inv)],
          [zero, zero]]
    dhi = [[zero, zero] for _ in range(3)]
    for i in range(3):
        M = [(R[i][0] * N[0][j] + R[i][1] * N[1][j]) + R[i][2] * N[2][j] for j in range(3)]
        dhi.append([(M[0] * UJ[0][j] + M[1] * UJ[1][j]) + M[2] * UJ[2][j] for j in range(2)])
    distance = np.sqrt(c0 * c0 + c1 * c1)
    max_distance = np.sqrt(u0 * u0 + v0 * v0)
    sdv = (distance / max_distance + one) * sd
    var = sdv * sdv
    Rm = [[one * var, zero * var], [zero * var, one * var]]
    T2 = np.zeros((6, 6), f32)
    for i in range(6):
        t0 = dhi[i][0] * Rm[0][0] + dhi[i][1] * Rm[1][0]
        t1 = dhi[i][0] * Rm[0][1] + dhi[i][1] * Rm[1][1]
        for j in range(6):
            T2[i, j] = t0 * dhi[j][0] + t1 * dhi[j][1]
    return dxp, T2, np.array(ypi, f32)


def new_rows_mirror(dxp: np.ndarray, P: np.ndarray, cols) -> np.ndarray:
    """csrc/ray_insert.cu's new_row at the columns cols: dxp[i] . P[0:7, c],
    each product rounded, left to right."""
    acc = dxp[:, 0:1] * P[0:1, cols]
    for k in range(1, 7):
        acc = acc + dxp[:, k : k + 1] * P[k : k + 1, cols]
    return acc


def block_mirror(dxp, T2, P) -> np.ndarray:
    nr7 = new_rows_mirror(dxp, P, np.arange(7))
    acc = nr7[:, None, 0] * dxp[None, :, 0]
    for k in range(1, 7):
        acc = acc + nr7[:, None, k] * dxp[None, :, k]
    return acc + T2


def bits(a) -> np.ndarray:
    a = np.asarray(a, f32)
    return np.where(np.isnan(a), f32(np.nan), a).view(np.int32)


def _twin_terms(state: SlamState, u, v, c: RayInsertConsts):
    """The twin's ray, dypi_by_dxp, dhi R dhi', new rows and block
    (add_partial_feature's expressions on the state as one lane)."""
    h = torch.stack([u, v]).to(state.x.dtype)[None]
    xp = state.x[None, :7]
    ypi, dxp, dhi = models.part_init_ray(c.cam, h, xp)
    new_rows = mm_seq(dxp, state.P[None, :7, :])
    T2 = mm_seq(mm_seq(dhi, measurement_noise(c.cam, h)), dhi.mT)
    pyy = mm_seq(new_rows[..., :7], dxp.mT) + T2
    return ypi[0], dxp[0], T2[0], new_rows[0], pyy[0]


@pytest.mark.parametrize("case", ("real", "shut_asym", "slot_last"))
def test_chain_mirror_equals_the_twin(cpu_inputs, case):
    """The kernel's scalar chain, transcribed in float32, gives the twin's
    bits: every term the insertion writes."""
    for t, a in enumerate(cpu_inputs):
        state, _f, ub, vb, *_ = variation(a, case, seed=t)
        ypi, dxp, T2, new_rows, pyy = _twin_terms(state, ub, vb, RIC)
        m_dxp, m_T2, m_ypi = chain_mirror(RIC, int(ub), int(vb), state.x.numpy()[:7])
        P = state.P.numpy()
        np.testing.assert_array_equal(bits(m_ypi), bits(ypi.numpy()), err_msg=f"{case} {t} ypi")
        np.testing.assert_array_equal(bits(m_dxp), bits(dxp.numpy()), err_msg=f"{case} {t} dxp")
        np.testing.assert_array_equal(bits(m_T2), bits(T2.numpy()), err_msg=f"{case} {t} T2")
        np.testing.assert_array_equal(bits(new_rows_mirror(m_dxp, P, np.arange(P.shape[0]))),
                                      bits(new_rows.numpy()), err_msg=f"{case} {t} rows")
        np.testing.assert_array_equal(bits(block_mirror(m_dxp, m_T2, P)), bits(pyy.numpy()),
                                      err_msg=f"{case} {t} block")


@pytest.mark.parametrize("u,v", [(0, 0), (319, 239), (162, 125), (5, 231), (300, 7)])
def test_chain_mirror_equals_the_twin_across_the_frame(cpu_inputs, u, v):
    """The corners, the centre and near-border picks; the pose of a late
    frame."""
    state = cpu_inputs[-1][0]
    ut, vt = torch.tensor(u, dtype=torch.int32), torch.tensor(v, dtype=torch.int32)
    ypi, dxp, T2, _rows, _pyy = _twin_terms(state, ut, vt, RIC)
    m_dxp, m_T2, m_ypi = chain_mirror(RIC, u, v, state.x.numpy()[:7])
    for m, w in ((m_ypi, ypi), (m_dxp, dxp), (m_T2, T2)):
        np.testing.assert_array_equal(bits(m), bits(w.numpy()))


# ------------------------------------------------------------------ the kernel's writes


def kernel_mirror(args: tuple, rows: int):
    """csrc/ray_insert.cu's k17_kernel on CPU tensors: each CTA's writes in
    its phases, from the chain mirror. Returns (state', did_init, writer)
    where writer[r, c] is the CTA that wrote P'[r, c] (-1: none); raises if
    two CTAs write one element."""
    state, frame, ub, vb, ev, ok, rng_new, lam0, c = args
    P, x = state.P.numpy(), state.x.numpy()
    D, MF, NP, B = P.shape[0], state.active.shape[0], state.lam.shape[1], c.boxsize
    enable = bool(ok) and f32(ev.item()) > f32(c.thresh)
    half = (B - 1) // 2
    pr0 = min(max(int(vb) - half, 0), c.H - B)
    pc0 = min(max(int(ub) - half, 0), c.W - B)
    # warp 1: the lanes' first free slot, their minimum
    act = state.active.numpy()
    first = min(min([m for m in range(lane, MF, 32) if not act[m]], default=MF) for lane in range(32))
    any_free = first < MF
    slot = first if any_free else 0
    doit = enable and any_free
    off = CAM_DIM + SLOT_DIM * slot
    S = range(off, off + SLOT_DIM)
    dxp, T2, ypi = chain_mirror(c, int(ub), int(vb), x[:7])
    blk = block_mirror(dxp, T2, P)
    Po = np.full_like(P, np.nan)
    xo = np.full_like(x, np.nan)
    writer = np.full(P.shape, -1)

    def write(r, col, val, cta, again=False):
        if writer[r, col] not in (-1, cta) or (writer[r, col] == cta and not again):
            raise AssertionError(f"P'[{r}, {col}] written by CTA {writer[r, col]} and CTA {cta}")
        writer[r, col] = cta
        Po[r, col] = val

    for b in range(math.ceil(D / rows)):
        r0, r1 = b * rows, min(D, (b + 1) * rows)
        for r in range(r0, r1):                   # before the barrier: the band but the slot's rows
            if r not in S:
                for col in range(D):
                    write(r, col, P[r, col], b)
        band = np.arange(r0, r1)
        nr = new_rows_mirror(dxp, P, band)        # after it
        for i in range(SLOT_DIM):
            si = off + i
            for k, j in enumerate(band):
                if j not in S:
                    val = nr[i, k] if doit else P[si, j]
                    write(si, j, val, b)
                    write(j, si, val, b, again=True)   # over this CTA's own copy
                else:
                    write(si, j, blk[i, j - off] if doit else P[si, j], b)
        for col in band:
            xo[col] = ypi[col - off] if doit and col in S else x[col]
    assert (writer >= 0).all(), "an element of P' was not written"

    def sel(arr, new):
        out = arr.clone()
        if doit:
            out[slot] = new
        return out

    patch = frame[pr0 : pr0 + B, pc0 : pc0 + B]
    p32 = patch.to(torch.int32)
    prow = torch.zeros(k17.PATCH_ROW, dtype=torch.float32)
    prow[: B * B] = patch.reshape(-1).to(torch.float32)
    prow[B * B] = float(int(p32.sum()))
    prow[B * B + 1] = float(int((p32 * p32).sum()))
    zi = torch.zeros((), dtype=torch.int32)
    out = state._replace(
        x=torch.from_numpy(xo), P=torch.from_numpy(Po), active=sel(state.active, True),
        full=sel(state.full, False), label=sel(state.label, state.next_label), patches=sel(state.patches, patch),
        patch_rows=sel(state.patch_rows, prow), xp_org=sel(state.xp_org, state.x[:7]),
        attempts=sel(state.attempts, zi), successes=sel(state.successes, zi), lam=sel(state.lam, lam0),
        prob=sel(state.prob, torch.tensor(f32(1.0 / NP))), palive=sel(state.palive, True),
        match_attempts=sel(state.match_attempts, zi), sched=sel(state.sched, False),
        next_label=state.next_label + int(doit), rng=rng_new)
    return out, torch.tensor(enable), writer


@pytest.mark.parametrize("rows", (1, 2, 4, 7, k17.MAX_ROWS))
@pytest.mark.parametrize("case", CASES)
def test_kernel_mirror_equals_add_partial_feature(cpu_inputs, case, rows):
    """The kernel's writes, band by band, leave what the twin's rows, then
    columns, then block leave: the gate shut on an asymmetric P writes the
    slot's old rows into its columns; a full map does so at slot 0."""
    for t in (8, 9, 10):     # before, at and after the first init
        v = variation(cpu_inputs[t], case, seed=t)
        got, did, _w = kernel_mirror(v, rows)
        want, want_did = ray_insert_plain(*v)
        assert same(did, want_did), (case, t)
        assert_same_state(got, want, f"{case} frame {t} rows {rows}")


def _wide_state(MF: int, NP: int, seed: int) -> tuple:
    """A seeded stage-7 input at MF slots: a random symmetric P with an
    asymmetric speck, some slots taken, the gate open."""
    g = np.random.default_rng(seed)
    p = dataclasses.replace(P_STD, max_features=MF, n_particles=NP)
    D = CAM_DIM + SLOT_DIM * MF
    s = st.init_state(p, np.r_[0.1, 0.2, -0.3, 0.9, 0.1, -0.3, 0.3, np.zeros(6)], np.eye(13) * 1e-4,
                      device="cpu", dtype=torch.float32)
    A = g.normal(size=(D, D)).astype(np.float32) * 1e-2
    P = torch.from_numpy(A @ A.T + np.eye(D, dtype=np.float32) * 1e-3)
    active = torch.from_numpy(g.uniform(size=MF) < 0.6)
    s = s._replace(P=asymmetric(P, seed, 1e-6), active=active,
                   x=s.x + torch.from_numpy(g.normal(size=D).astype(np.float32)) * 0.1,
                   lam=torch.from_numpy(g.uniform(size=(MF, NP)).astype(np.float32)),
                   next_label=torch.tensor(17, dtype=torch.int32))
    frame = torch.from_numpy(g.integers(0, 256, (P_STD.cam_height, P_STD.cam_width), dtype=np.uint8))
    lam0 = torch.as_tensor(st.lambda_grid(p), dtype=torch.float32)
    return (s, frame, torch.tensor(int(g.integers(0, 320)), dtype=torch.int32),
            torch.tensor(int(g.integers(0, 240)), dtype=torch.int32), torch.tensor(f32(1e4)),
            torch.tensor(True), torch.tensor([1, 2, 3], dtype=torch.int32), lam0, RIC)


@pytest.mark.parametrize("MF,NP,rows", [(60, 200, 3), (100, 100, 5), (128, 50, 6), (1, 7, 2)])
def test_kernel_mirror_at_large_maps(MF, NP, rows):
    """The hires, mf100 and largest slot counts (D = 373, 613, 781) and a
    single slot, on seeded states: the mirror against the twin."""
    v = _wide_state(MF, NP, seed=MF)
    got, did, _w = kernel_mirror(v, rows)
    want, want_did = ray_insert_plain(*v)
    assert same(did, want_did)
    assert_same_state(got, want, f"MF {MF}")


# ------------------------------------------------------------------ shared sizes and layouts


def _define(name: str) -> int:
    with open(CSRC) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


def _struct_fields(name: str) -> list[str]:
    with open(CSRC) as f:
        body = re.search(rf"struct {name} \{{(.*?)\}};", f.read(), re.S).group(1)
    out = []
    for decl in body.split(";"):
        decl = re.sub(r"//[^\n]*", "", decl).strip()
        if decl:
            out += [n.strip().lstrip("*") for n in re.sub(r"^(const )?\w+\*? ", "", decl).split(",")]
    return out


def test_sizes_shared_with_the_source():
    assert _define("K17_MAX_MF") == k17.MAX_MF
    assert _define("K17_THREADS") == k17.THREADS
    assert _define("K17_MAX_ROWS") == k17.MAX_ROWS
    assert _define("K17_PATCH_ROW") == k17.PATCH_ROW == st.patch_row(torch.zeros(11, 11, dtype=torch.uint8)).shape[-1]
    assert (_define("K17_CAM"), _define("K17_SLOT"), _define("K17_XP")) == (CAM_DIM, SLOT_DIM, 7)
    # after the barrier a thread a new-row entry of the band, and the last 42 the block's rows at 0..6
    assert SLOT_DIM * k17.MAX_ROWS <= k17.THREADS - SLOT_DIM * 7
    assert P_STD.boxsize ** 2 + 2 <= k17.PATCH_ROW


def test_structs_match_the_source():
    assert _struct_fields("K17Params") == [n for n, _ in k17._K17Params._fields_]
    assert _struct_fields("K17Ptrs") == list(k17.PTR_FIELDS) == [n for n, _ in k17._K17Ptrs._fields_]
    ints = [n for n, t in k17._K17Params._fields_ if t is __import__("ctypes").c_int]
    assert ints == ["H", "W", "B", "MF", "NP", "D", "rows"]


@pytest.mark.parametrize("D,n_sms", [(19, 132), (109, 132), (373, 132), (613, 132), (781, 132), (781, 8), (109, 1)])
def test_band_rows_stay_in_bounds(D, n_sms):
    rows = k17.band_rows(D, n_sms)
    assert k17.MIN_ROWS <= rows <= k17.MAX_ROWS
    assert math.ceil(D / rows) <= max(n_sms, math.ceil(D / k17.MAX_ROWS))


def test_bytes_and_flops_grow_with_the_map():
    b16, f16 = k17.bytes_and_flops(16, 100, 11)
    b128, f128 = k17.bytes_and_flops(128, 200, 11)
    assert b16 >= 2 * (109 * 109 * 4) and b128 > b16 and f128 > f16 > 300


# ------------------------------------------------------------------ on the card


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def check_on_card(args, what: str) -> None:
    got, did = ray_insert(*args)
    want, want_did = ray_insert_plain(*args)
    torch.cuda.synchronize()
    assert same(did, want_did), f"{what}: did_init"
    assert_same_state(got, want, what)


@pytest.fixture(scope="module")
def std_card_inputs(tmp_path_factory):
    _need_card()
    return _replay_inputs(tmp_path_factory.mktemp("std_card"), "cuda", 240, max_features=16)


@pytest.mark.chip
def test_k17_equals_its_twin_on_every_std_frame(std_card_inputs):
    assert len(std_card_inputs) == 239
    n_init = 0
    for t, a in enumerate(std_card_inputs):
        check_on_card(a, f"std frame {t}")
        n_init += int(bool(a[5]) and float(a[4]) > a[8].thresh)
    assert n_init > 0


@pytest.mark.chip
@pytest.mark.parametrize("case", CASES[1:])
def test_k17_equals_its_twin_on_variations(std_card_inputs, case):
    for t in (9, 20, 120):
        state, *rest = std_card_inputs[t]
        cpu = SlamState(*(f.cpu() for f in state))
        v = variation((cpu, *rest), case, seed=t)
        check_on_card((SlamState(*(f.cuda() for f in v[0])),) + tuple(v[1:]), f"{case} frame {t}")


@pytest.mark.chip
@pytest.mark.parametrize("name", ("hires", "mf100"))
def test_k17_equals_its_twin_on_the_large_maps(tmp_path, name):
    _need_card()
    if name == "hires":
        inputs = _replay_inputs(tmp_path, "cuda", 12, params=Params(**HIRES_PARAMS), **HIRES_OVERRIDES)
        D = 373
    else:
        inputs = _replay_inputs(tmp_path, "cuda", 12, max_features=100)
        D = 613
    assert inputs and inputs[0][0].P.shape[0] == D
    inits = [a for a in inputs if bool(a[5]) and float(a[4]) > a[8].thresh]
    assert inits, f"{name}: no init in the first frames"
    for t, a in enumerate([inits[0], inputs[-1]]):
        check_on_card(a, f"{name} input {t}")


@pytest.mark.chip
def test_k17_at_the_largest_map_on_the_card():
    _need_card()
    v = _wide_state(128, 200, seed=3)
    check_on_card((SlamState(*(f.cuda() for f in v[0])),) + tuple(
        t.cuda() if isinstance(t, torch.Tensor) else t for t in v[1:]), "MF 128")


@pytest.mark.chip
def test_replay_with_k17_equals_the_replay_with_its_twin(tmp_path, monkeypatch):
    """The std replay's packed rows and final state, graphs and all, are the
    same bits with the twin in K17's place."""
    _need_card()
    import scenelib2_torch.runtime.step as step_mod

    frames, _, _, cfg = generate_dataset(str(tmp_path), n_frames=60, seed=7)
    seq = torch.as_tensor(frames[1:]).cuda()
    runs = []
    for fn in (ray_insert, ray_insert_plain):
        monkeypatch.setattr(step_mod, "ray_insert", fn)
        slam = MonoSLAM(cfg, max_features=16, device="cuda")
        outs = slam.run_sequence(seq, enable_mapping=True)
        torch.cuda.synchronize()
        runs.append((outs, slam.state))
    (o1, s1), (o2, s2) = runs
    assert int(o1.did_init.sum()) > 0
    for name, a, b in zip(o1._fields, o1, o2):
        assert same(a, b), f"outputs: {name}"
    assert_same_state(s1, s2, "final state")
