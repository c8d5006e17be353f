"""K5 past its old 16-try cap and K7 with the selection taken in.

K5 (kernels/propose.py, csrc/propose.cu) takes any number of tries: each
draw is one jump from the input state, x_k = (A_k x_0 + C_k) mod 2^48, from
the table propose.jump_table makes in Python ints, and each warp of the
kernel decides every nwarps-th try, a shared minimum keeping the first free
one. K7 (kernels/measure.py, csrc/measure.cu) reads the step's x and P in
place and writes the top-NSEL selection, the visible count and the
selected rows; its rank counts, for each slot, the slots whose 64-bit key
(the score's order-preserving bits, then the slot's complement) is larger,
in four interleaved parts summed by atomics.

Held here, exactly (integers, limbs, decisions, and floats bit for bit):
  - the kernel's jump-ahead, mirrored in Python ints, against
    rng.drand48_many draw by draw for 128 draws from several states, and
    its f32 draw values against propose.draw_values_f32;
  - propose_plain against JAX's pallas_propose_init (interpret mode) at 17
    and 40 tries, on the port's CPU replay's real-frame inputs and on a map
    where every try clashes (all 2 tries draws consumed);
  - the kernel's try decision (warps, first free try, atomicMin) mirrored
    against the twin's first free try;
  - K5's step form (propose_region_plain: the gate, the clamp and the init
    box taken into the kernel) against the step's former glue around
    propose_plain, on every captured frame and with the gate shut by speed,
    by the visible count and by a partial slot, and without room;
  - measure_select_plain against the composition the split stages ran
    before K7 took the selection in (the slot gathers, measure_predict_plain,
    the visible count, stable_top_k, the gather and its unpacking), on the
    CPU batch replay's captured inputs, a lane with a NaN score, a lane
    with nothing visible, a lane of equal scores and one lane of 100 slots;
  - the kernel's rank keys and four-part rank mirrored against
    stable_top_k (any NaN first, -inf, -0 equal to +0, ties to the lowest
    slot);
  - the sizes and output layout the wrappers share with the sources.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_propose import pallas_propose_init
from scenelib2_torch.config import Params
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.kernels import measure, propose
from scenelib2_torch.kernels.measure import (
    O_H,
    O_HX,
    O_HY,
    O_RD,
    O_S,
    O_SCORE,
    O_SINV,
    O_VIS,
    MeasureConsts,
    measure_predict_plain,
    measure_select_plain,
    stable_top_k,
)
from scenelib2_torch.kernels.propose import (
    ProposeConsts,
    draw_values_f32,
    jump_table,
    propose_plain,
    propose_region_plain,
)
from scenelib2_torch.kernels.shi_tomasi import clamp_region
from scenelib2_torch.parallel.mesh import make_batched_step
from scenelib2_torch.rng import drand48_many, pack_state, srand48
from scenelib2_torch.runtime import state as st
from tests.test_torch_batch_kernels import _capture as batch_capture
from tests.test_torch_mapping_kernels import _k5_case, real_inputs  # noqa: F401 (a fixture)

CSRC = os.path.join(os.path.dirname(measure.__file__), "csrc")
P_STD = Params()
P16 = dataclasses.replace(P_STD, max_features=16)
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize
CAM = (P_STD.cam_fku, P_STD.cam_fkv, P_STD.cam_u0, P_STD.cam_v0, P_STD.cam_kd1)
PC = ProposeConsts.from_params(P_STD)
MC = MeasureConsts.from_params(P16)
NSEL = P16.n_features_to_select
MASK48 = (1 << 48) - 1
K7_PARTS = 4
BATCH_LANES = (0, 33)
N_BATCH_STEPS = 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _define(src: str, name: str) -> int:
    with open(os.path.join(CSRC, src)) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


# ---------------------------------------------------------------------- K5


def kernel_draws(limbs, n: int) -> list[int]:
    """csrc/propose.cu's jump(): the state after each of n draws, from the
    jump table, x0 composed from the limbs as the kernel does, the product
    and sum taken mod 2^64 (uint64) and masked to 48 bits."""
    x0 = int(limbs[0]) | int(limbs[1]) << 16 | int(limbs[2]) << 32
    table = jump_table((n + 1) // 2, "cpu").tolist()[:n]
    return [(((a * x0) % (1 << 64) + c) % (1 << 64)) & MASK48 for a, c in table]


def kernel_value(x: int) -> np.float32:
    """csrc/propose.cu's draw_value(): the limbs' value in f32, each
    operation rounded to f32."""
    f = np.float32
    r0, r1, r2 = f(x & 0xFFFF), f((x >> 16) & 0xFFFF), f((x >> 32) & 0xFFFF)
    return f(f(f(r2 * f(4294967296.0)) + f(r1 * f(65536.0))) + r0) * f(3.552713678800501e-15)


STATES = {"srand48(0)": pack_state(srand48(0)), "srand48(1)": pack_state(srand48(1)),
          "srand48(2026)": pack_state(srand48(2026)), "drawn": np.array([61436, 53799, 53274])}


@pytest.mark.parametrize("state", list(STATES))
def test_jump_ahead_equals_drand48_many_draw_by_draw(state):
    limbs = torch.tensor(STATES[state].astype(np.int64), dtype=torch.int32)
    n = 200   # 100 tries: past the K5_STAGE draws the kernel stages, it jumps
    want, _ = drand48_many(limbs, n)                         # [n, 3] limbs after each draw
    got = kernel_draws(limbs.tolist(), n)
    got_limbs = [[x & 0xFFFF, (x >> 16) & 0xFFFF, (x >> 32) & 0xFFFF] for x in got]
    assert got_limbs == want.tolist()
    vals = draw_values_f32(want).numpy()
    np.testing.assert_array_equal(np.array([kernel_value(x) for x in got], np.float32).view(np.int32),
                                  vals.view(np.int32))


def kernel_first_free(clash: np.ndarray, MF: int) -> int:
    """csrc/propose.cu's decision: warp w of the block's 1 + ceil(MF / 32) +
    K5_STAGE / 32 takes tries w, w + nwarps, ...; a try no slot clashes with
    enters an atomicMin and ends that warp's walk. Returns the minimum
    (tries where none is free)."""
    tries = clash.shape[0]
    nwarps = 1 + (MF + 31) // 32 + _define("propose.cu", "K5_STAGE") // 32
    first = tries
    for w in range(nwarps):
        for i in range(w, tries, nwarps):
            if not clash[i].any():
                first = min(first, i)
                break
    return first


@pytest.mark.parametrize("tries,MF,density", [(1, 16, 0.02), (5, 16, 0.05), (17, 16, 0.08), (40, 60, 0.03),
                                              (40, 1, 0.5), (100, 128, 0.01), (100, 100, 0.0), (64, 33, 1.0)])
def test_try_decision_mirror_takes_the_first_free_try(tries, MF, density):
    g = np.random.default_rng(tries * 1000 + MF)
    for _ in range(50):
        clash = g.uniform(size=(tries, MF)) < density
        ok = torch.as_tensor(~clash.any(axis=1))
        # the twin: argmax of ok (0 if none) with any_ok_raw = ok.any()
        want = int(torch.argmax(ok.to(torch.int32))) if bool(ok.any()) else tries
        assert kernel_first_free(clash, MF) == want


def _k5_jax(x, rng, occ, want, tries):
    us, vs, ok, rng_new = pallas_propose_init(
        jnp.asarray(x.numpy()), jnp.asarray(rng.numpy().astype(np.uint32)), jnp.asarray(occ.numpy()),
        jnp.asarray(bool(want)), image_shape=(H, W), region_w_cfg=PC.region_w, region_h_cfg=PC.region_h,
        boxsize=B, tries=tries, sep=PC.sep, dtN=PC.dtN, depth=PC.depth, cam_static=CAM, interpret=True)
    return int(us), int(vs), bool(ok), np.asarray(rng_new).astype(np.int64)


@pytest.mark.parametrize("tries", [17, 40])
@pytest.mark.parametrize("case", ["first_init", "seeded", "all_clash"])
def test_k5_plain_matches_pallas_past_16_tries(case, tries, real_inputs):  # noqa: F811
    x, rng, occ, want = _k5_case(case, real_inputs)
    c = dataclasses.replace(PC, tries=tries)
    us, vs, ok, rng_new = propose_plain(x, rng, occ, want, c)
    want_us, want_vs, want_ok, want_rng = _k5_jax(x, rng, occ, want, tries)
    assert (int(us), int(vs), bool(ok)) == (want_us, want_vs, want_ok), (case, tries)
    np.testing.assert_array_equal(rng_new.numpy(), want_rng)
    states, _ = drand48_many(rng, 2 * tries)
    if case == "all_clash":
        # no free try: every draw consumed, rng_new the last draw's limbs
        assert not want_ok and torch.equal(rng_new, states[-1])
    else:
        assert want_ok and any(torch.equal(rng_new, s) for s in states)


def _old_glue(x, rng, active, full, speed, n_visible, p: Params):
    """Stage 7's proposal as the step ran it before K5 took its glue in:
    the gate, K5 on the active full slots, the clamp, the init box."""
    n_partial = (active & ~full).sum().to(torch.int32)
    want_init = ((speed > p.min_speed_for_init) & (n_visible < p.n_features_to_keep_visible)
                 & (n_partial < p.max_features_to_init_at_once))
    us, vs, any_ok, rng_new = propose_plain(x, rng, active & full, want_init, ProposeConsts.from_params(p))
    RW, RH = p.init_search_width, p.init_search_height
    ru, rv, ruf, rvf = clamp_region(us, vs, us + RW, vs + RH, p.cam_width, p.cam_height, p.boxsize)
    init_box = torch.where(want_init, torch.stack([us, vs]), torch.zeros(2, dtype=torch.int32))
    return ru, rv, ruf, rvf, any_ok, rng_new, init_box


@pytest.mark.parametrize("case", ["every_frame", "slow", "enough_visible", "partial_slot", "no_room"])
def test_k5_step_form_twin_equals_the_former_glue(case, real_inputs):  # noqa: F811
    frames = sorted(t for (n, t) in real_inputs if n == "propose_region")
    if case != "every_frame":
        frames = [9]
    wants = []
    for t in frames:
        x, rng, active, full, speed, n_visible, c = real_inputs[("propose_region", t)][0]
        active, full = active.clone(), full.clone()
        if case == "slow":
            speed = torch.tensor(np.float32(P_STD.min_speed_for_init))      # not above the threshold
        elif case == "enough_visible":
            n_visible = torch.tensor(P_STD.n_features_to_keep_visible, dtype=torch.int32)
        elif case == "partial_slot":
            active[-1], full[-1] = True, False
        elif case == "no_room":
            x = x.clone()
            x[7:10] = torch.tensor([0.0, -20.0, 0.0])
        got = propose_region_plain(x, rng, active, full, speed, n_visible, c)
        want = _old_glue(x, rng, active, full, speed, n_visible, P_STD)
        for name, g, w in zip(got._fields, got, want):
            assert torch.equal(g, w), (case, t, name)
        wants.append(bool(got.init_box.any()))
    if case == "every_frame":
        assert any(wants) and not all(wants)       # the gate opens on some frames only
    else:
        assert not bool(got.any_ok) and (case == "no_room") == bool(got.init_box.any())


# ---------------------------------------------------------------------- K7


def _composed(x, P, xpo, active, full, nsel, c):
    """Stage 2 of the split stages as the step ran it before K7 took the
    selection in: the slot gathers, the chain, the visible count,
    stable_top_k, the gather and its unpacking."""
    Bn, MF = active.shape
    act_full = active & full
    meas = measure_predict_plain(
        x[:, :7], P[:, :7, :7], st.slot_states(x, MF)[..., :3], xpo,
        st.slot_pxy(P, MF)[..., :7, :3], st.slot_pyy(P, MF)[..., :3, :3], act_full, c)
    n_visible = (act_full & (meas[:, O_VIS] == 0.0)).sum(-1).to(torch.int32)
    top_score, top_idx = stable_top_k(meas[:, O_SCORE], nsel)
    sel = torch.gather(meas, 2, top_idx.long()[:, None, :].expand(Bn, meas.shape[1], nsel))
    return (top_idx, top_score, n_visible, sel[:, O_H : O_H + 2].mT,
            sel[:, O_HX : O_HX + 14].mT.reshape(Bn, nsel, 2, 7),
            sel[:, O_HY : O_HY + 6].mT.reshape(Bn, nsel, 2, 3), sel[:, O_RD],
            torch.stack([sel[:, O_S], sel[:, O_S + 1], sel[:, O_S + 1], sel[:, O_S + 2]],
                        dim=-1).reshape(Bn, nsel, 2, 2),
            sel[:, O_SINV : O_SINV + 3].mT.contiguous(), meas)


def _scene(seed: int, MF: int, kinds: tuple):
    """(x, P, xp_org, active, full) of one lane per kind, near the std start
    pose: "random" (most slots active, some partial), "nan" (slot 3's point
    covariance overflows S: a NaN score), "none" (nothing active), "equal"
    (every slot the same point, capture pose and covariance)."""
    g = np.random.default_rng(seed)
    D = 13 + 6 * MF
    lanes = []
    for kind in kinds:
        x = np.zeros(D)
        x[3] = 1.0
        x[4:7] = g.normal(0, 0.02, 3)
        x[2] = -0.8
        for k in range(MF):
            x[13 + 6 * k : 16 + 6 * k] = [g.uniform(-0.3, 0.3), g.uniform(-0.2, 0.2), 0.0]
        xpo = np.tile(x[:7], (MF, 1))
        xpo[:, :3] += g.normal(0, 0.005, (MF, 3))
        A = g.normal(size=(D, D))
        P = (A @ A.T / (4 * D) + np.eye(D)) * 1e-4
        active = g.uniform(size=MF) > 0.15
        full = g.uniform(size=MF) > 0.1
        if kind == "nan":
            o = 13 + 6 * 3
            P[o, o], P[o + 1, o + 1] = 1e36, -1e36
            active[3] = full[3] = True
        elif kind == "none":
            active[:] = False
        elif kind == "equal":
            x[13:] = np.tile(x[13:19], MF)
            xpo[:] = xpo[0]
            P = np.eye(D) * 1e-4
            active[:] = full[:] = True
        lanes.append((x, P, xpo, active, full))
    f = dict(dtype=torch.float32)
    x, P, xpo, active, full = (np.stack(t) for t in zip(*lanes))
    return (torch.tensor(x, **f), torch.tensor(P, **f), torch.tensor(xpo, **f), torch.tensor(active),
            torch.tensor(full))


@pytest.fixture(scope="module")
def batch_captures(tmp_path_factory):
    """K7's arguments on the output indices of the port's CPU batch replay
    of lanes 0 and 33, mapping on."""
    params, states, frames = make_lanes(str(tmp_path_factory.mktemp("lanes")), n_frames=N_BATCH_STEPS + 2,
                                        device="cpu", dtype=torch.float32, lanes=BATCH_LANES)
    step = make_batched_step(params, device="cpu")
    store, frame_no = {}, [0]
    with batch_capture(store, frame_no):
        for t in range(N_BATCH_STEPS):
            frame_no[0] = t
            states, _o = step(states, torch.as_tensor(frames[t]), True)
    return {t: a for (n, t), (a, _k) in store.items() if n == "measure_select"}


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, NaN equal to NaN."""
    a, b = a.contiguous(), b.contiguous()
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if not a.is_floating_point():
        return torch.equal(a, b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


@pytest.mark.parametrize("case", ["real3", "real11", "nan", "none", "equal", "mf100"])
def test_k7_twin_equals_the_former_stage_2(case, batch_captures):
    if case.startswith("real"):
        args, nsel, c = batch_captures[int(case[4:])][:5], NSEL, MC
    elif case == "mf100":
        p = dataclasses.replace(P_STD, max_features=100)
        args, nsel, c = _scene(100, 100, ("random",)), p.n_features_to_select, MeasureConsts.from_params(p)
    else:
        args, nsel, c = _scene({"nan": 1, "none": 2, "equal": 3}[case], 16, (case, "random")), NSEL, MC
    got = measure_select_plain(*args, nsel, c, rows=True)
    want = _composed(*args, nsel, c)
    for name, g, w in zip(got._fields, got, want):
        assert _same(g, w), (case, name)
    score, top_idx, top_score = want[-1][:, O_SCORE], got.top_idx, got.top_score
    if case == "nan":
        # the NaN score ranks first and is not selected (top_score > -inf is false)
        assert bool(score[0, 3].isnan()) and int(top_idx[0, 0]) == 3 and not bool(top_score[0, 0] > -math.inf)
    elif case == "none":
        assert int(got.n_visible[0]) == 0 and top_idx[0].tolist() == list(range(nsel))
        assert bool(top_score[0].isneginf().all())
    elif case == "equal":
        assert top_idx[0].tolist() == list(range(nsel)) and int(got.n_visible[0]) > nsel
    elif case == "mf100":
        assert got.rows.shape == (1, measure.NOUT, 100) and int(got.n_visible[0]) >= nsel
    else:
        assert int(got.n_visible.sum()) >= 4


def rank_key(v: float, slot: int) -> int:
    """csrc/measure.cu's rank_key: the f32 score's order-preserving bits
    (any NaN above every number, -0 as +0), then the complement of the slot."""
    if math.isnan(v):
        hi = 0xFFFFFFFF
    else:
        u = int(np.array([0.0 if v == 0.0 else v], np.float32).view(np.uint32)[0])
        hi = (~u & 0xFFFFFFFF) if u & 0x80000000 else u | 0x80000000
    return hi << 32 | (0xFFFFFFFF - slot)


def kernel_rank(score: list[float], nsel: int) -> list[int]:
    """csrc/measure.cu's rank: part p of slot j counts the slots i = p,
    p + 4, ... whose key is larger; the parts' counts summed; a slot of rank
    r < nsel is top r."""
    MF = len(score)
    keys = [rank_key(v, j) for j, v in enumerate(score)]
    rank = [0] * MF
    for p in range(K7_PARTS):
        for j in range(MF):
            rank[j] += sum(keys[i] > keys[j] for i in range(p, MF, K7_PARTS))
    top = [-1] * nsel
    for j in range(MF):
        if rank[j] < nsel:
            top[rank[j]] = j
    return top


@pytest.mark.parametrize("MF,nsel", [(16, 10), (60, 12), (100, 10), (128, 128), (5, 5)])
def test_k7_rank_mirror_orders_as_stable_top_k(MF, nsel):
    g = np.random.default_rng(MF)
    for trial in range(20):
        s = g.choice(np.array([0.5, 1.0, 2.0, 0.0, -0.0, -1.5, np.inf, -np.inf, np.nan, -np.nan], np.float32),
                     size=MF) if trial % 2 else g.normal(size=MF).astype(np.float32)
        if trial % 5 == 0:
            s[:] = s[0]
        _v, idx = stable_top_k(torch.as_tensor(s)[None], nsel)
        assert kernel_rank(s.tolist(), nsel) == idx[0].tolist()


def test_wrappers_share_sizes_and_layout_with_the_sources():
    assert _define("measure.cu", "K7_MAX_MF") == measure.MAX_MF == 128
    assert _define("measure.cu", "K7_PARTS") == K7_PARTS
    assert _define("propose.cu", "K5_MAX_MF") == propose.MAX_MF == 128
    at = 0
    for name, n in measure.SEL_LAYOUT:
        key = {"top_score": "SEL_SCORE", "h_sel": "SEL_H", "hx_sel": "SEL_HX", "hy_sel": "SEL_HY",
               "Rd_sel": "SEL_RD", "S_sel": "SEL_S", "sinv_abc": "SEL_SINV"}[name]
        assert _define("measure.cu", key) == at, name
        assert math.prod(measure.SEL_SHAPES[name]) == n, name
        at += n
    # the step builds K5's table once, for the tries it runs
    t = jump_table(PC.tries, "cpu")
    assert t.shape == (2 * PC.tries, 2) and t.dtype == torch.int64 and jump_table(PC.tries, "cpu") is t
