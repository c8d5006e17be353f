"""The plain versions of the batch-step kernels K7, K9, K10 and K11 against
the JAX Pallas kernels they port, and against the port's K4 twin.

Each plain PyTorch version (what CPU tensors run through the kernel wrapper)
is held against its TPU kernel run in Pallas interpret mode in this process,
on the same inputs: the inputs that the port's own CPU batch replay hands
each wrapper on real frames (four lanes: two textures x two phase offsets,
22 frames, with fresh rays, conversions and lanes without a partial
feature), and seeded scenes that reach the other cases.

Tolerances: integers, masks and decisions exactly. K7: for every active,
fully initialised slot (the slots the step can select) each quantity (h, hx,
hy, R, S, S^-1, depth, score) within 1e-5 of that slot's largest entry of
the quantity (XLA's f32 sqrt on the CPU is off by an ulp at times where
PyTorch's is correctly rounded; single Jacobian entries are small by
cancellation, so an entry is held to its matrix's scale; a free or ray slot
read as a point is ill-conditioned and never selected, so only its flags
and its -inf score are compared); the visibility flags and the selection
exactly. K9's valid cells within 2e-5 absolute plus 2e-5 relative (a score
far from a match reaches 4 and carries the rounding of larger cancelling
sums), its invalid cells exactly 1e6 and exactly the same set, the
penalized cells the same set, with and without the TPU kernel's banded
form (a low-contrast image, sigma ~2 at mean 104, within 1e-3 relative: its
variance cancels 2,000 to 1 in f32). On a perfectly flat image or patch the port returns the reference's
zero-variance specials (1, plus the penalty for a flat image) and only the
invalid cells are compared: XLA turns the TPU kernel's division by the
constant 121 into a multiplication by its reciprocal, which leaves a flat
window a variance of rounding size instead of 0, so the JAX kernel misses
its own special case there. K10's rows within 1e-4 of each row's largest entry (the bar of
K4's prediction rows, for the same reason) and exactly equal to the rows of
the port's merged K4 twin. K11's decisions, found and z exactly, its
probabilities and moments within 1e-5 relative (the depth variance, a
difference of two moments, within 1e-5 of the squared mean), and exactly
equal to the port's K4 twin when given K9's map of the same frame and patch.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_measure import pallas_measure_predict
from scenelib2_tpu.kernels.pallas_particle import pallas_particle_predict_fused
from scenelib2_tpu.kernels.pallas_score_map import pallas_score_maps
from scenelib2_tpu.kernels.pallas_search_bayes import pallas_search_bayes
from scenelib2_torch.config import Params
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.measure import (
    O_SCORE,
    O_VIS,
    MeasureConsts,
    chain_inputs,
    measure_predict_plain,
    measure_select,
    measure_select_plain,
    stable_top_k,
)
from scenelib2_torch.kernels.particle import ParticleConsts, particle_predict_plain
from scenelib2_torch.kernels.score_map import MISS, ScoreMapConsts, score_map_plain
from scenelib2_torch.kernels.search_bayes import (
    SearchBayesConsts,
    search_bayes_maps_plain,
    search_bayes_plain,
)
from scenelib2_torch.parallel.mesh import make_batched_step
from scenelib2_torch.runtime import state as st
from tests.test_pallas_search_bayes import CASES as SB_CASES
from tests.test_pallas_search_bayes import _fused, _pred_rows, _scenario

P_STD = dataclasses.replace(Params(), max_features=16)
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize
MF, NSEL, NP = P_STD.max_features, P_STD.n_features_to_select, P_STD.n_particles
CAM = (P_STD.cam_fku, P_STD.cam_fkv, P_STD.cam_u0, P_STD.cam_v0, P_STD.cam_kd1)
MC = MeasureConsts.from_params(P_STD)
SMC = ScoreMapConsts.from_params(P_STD)
SBC = SearchBayesConsts.from_params(P_STD)
PCN = ParticleConsts.from_params(P_STD)
LANES = (0, 1, 32, 33)
N_STEPS = 22
# K7's rows by quantity (first row, past the last row): h, hx, hy, R, S, S^-1, depth, score
K7_GROUPS = ((0, 2), (2, 16), (16, 22), (22, 23), (23, 26), (26, 29), (30, 31), (31, 32))
K7_TOL = 1e-5
MAP_ATOL = MAP_RTOL = 2e-5
ROW_TOL_K10 = 1e-4
PROB_RTOL = 1e-5
BATCH_WRAPPERS = ("measure_select", "search", "shi_tomasi", "score_map", "particle_predict",
                  "search_bayes_maps")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _capture(store: dict, frame_no: list):
    """Record the arguments of the batch step's kernel wrappers, by frame."""
    import scenelib2_torch.runtime.step as step_mod

    orig = {n: getattr(step_mod, n) for n in BATCH_WRAPPERS}

    def wrap(n):
        def call(*a, **k):
            store[(n, frame_no[0])] = (a, k)
            return orig[n](*a, **k)
        return call

    for n in BATCH_WRAPPERS:
        setattr(step_mod, n, wrap(n))
    try:
        yield
    finally:
        for n in BATCH_WRAPPERS:
            setattr(step_mod, n, orig[n])


@pytest.fixture(scope="module")
def batch_inputs(tmp_path_factory):
    """The wrappers' inputs on output indices 0..21 of the port's CPU batch
    replay of lanes 0, 1, 32, 33, mapping on, and the per-frame outputs."""
    params, states, frames = make_lanes(str(tmp_path_factory.mktemp("lanes")), n_frames=N_STEPS + 2,
                                        device="cpu", dtype=torch.float32, lanes=LANES)
    step = make_batched_step(params, device="cpu")
    store, frame_no, outs = {}, [0], []
    with _capture(store, frame_no):
        for t in range(N_STEPS):
            frame_no[0] = t
            states, o = step(states, torch.as_tensor(frames[t]), True)
            outs.append(o)
    return store, outs


def _frame_with(batch_inputs, pred):
    """The first captured frame index whose K11 call satisfies pred(args, outs)."""
    store, outs = batch_inputs
    for t in range(N_STEPS):
        if pred(store[("search_bayes_maps", t)][0], outs[t]):
            return t
    raise AssertionError("no captured frame has the wanted case")


# ---------------------------------------------------------------------- K7


def _k7_jax(args):
    xp, pxx7, ys3, xpo, pxy, pyy, act = (np.asarray(t.numpy()) for t in args)
    out = []
    for b in range(xp.shape[0]):
        out.append(np.asarray(pallas_measure_predict(
            jnp.asarray(xp[b]), jnp.asarray(pxx7[b]), jnp.asarray(ys3[b]), jnp.asarray(xpo[b]),
            jnp.asarray(pxy[b]), jnp.asarray(pyy[b]), jnp.asarray(act[b]), cam_static=CAM,
            sd0=P_STD.cam_sd, image_shape=(H, W), boundary=P_STD.image_search_boundary,
            max_length_ratio=P_STD.max_length_ratio,
            max_angle_difference=P_STD.max_angle_difference, interpret=True)))
    return np.stack(out)


def _k7_random(seed: int, n_lanes: int = 3):
    """Seeded lanes near the std start pose: points in front of the camera,
    a dense small covariance, most slots active and full."""
    g = np.random.default_rng(seed)
    D = 13 + 6 * MF
    xs, Ps, xpos, acts = [], [], [], []
    for _ in range(n_lanes):
        x = np.zeros(D)
        x[3] = 1.0
        x[4:7] = g.normal(0, 0.02, 3)
        x[2] = -0.8
        for k in range(MF):
            x[13 + 6 * k : 16 + 6 * k] = [g.uniform(-0.3, 0.3), g.uniform(-0.2, 0.2), 0.0]
        xpo = np.tile(x[:7], (MF, 1))
        xpo[:, :3] += g.normal(0, 0.005, (MF, 3))
        A = g.normal(size=(D, D))
        Ps.append((A @ A.T / (4 * D) + np.eye(D)) * 1e-4)
        xs.append(x)
        xpos.append(xpo)
        acts.append(g.uniform(size=MF) > 0.2)
    f = dict(dtype=torch.float32)
    x, P = torch.tensor(np.stack(xs), **f), torch.tensor(np.stack(Ps), **f)
    return [x[:, :7], P[:, :7, :7], st.slot_states(x, MF)[..., :3], torch.tensor(np.stack(xpos), **f),
            st.slot_pxy(P, MF)[..., :7, :3], st.slot_pyy(P, MF)[..., :3, :3],
            torch.tensor(np.stack(acts))]


def _k7_case(case, batch_inputs):
    if case.startswith("real"):
        x, P, xpo, active, full = batch_inputs[0][("measure_select", int(case[4:]))][0][:5]
        a = list(chain_inputs(x, P, xpo, active & full))
    else:
        a = _k7_random({"random": 3, "all_invisible": 4, "equal_scores": 5}[case])
    if case == "all_invisible":
        a[6] = torch.zeros_like(a[6])
    if case == "equal_scores":
        # every slot the same point, capture pose and covariance blocks
        a[2] = a[2][:, :1].expand_as(a[2]).contiguous()
        a[3] = a[3][:, :1].expand_as(a[3]).contiguous()
        a[4] = a[4][:, :1].expand_as(a[4]).contiguous()
        a[5] = a[5][:, :1].expand_as(a[5]).contiguous()
        a[6] = torch.ones_like(a[6])
    return a


@pytest.mark.parametrize("case", ["real3", "real15", "real21", "random", "all_invisible",
                                  "equal_scores"])
def test_k7_plain_matches_pallas(case, batch_inputs):
    args = _k7_case(case, batch_inputs)
    got = measure_predict_plain(*args, MC).numpy()
    want = _k7_jax(args)
    assert got.shape == want.shape == (args[0].shape[0], 32, MF)
    np.testing.assert_array_equal(got[:, O_VIS], want[:, O_VIS], err_msg=case)
    np.testing.assert_array_equal(np.isneginf(got[:, O_SCORE]), np.isneginf(want[:, O_SCORE]))
    act = args[6].numpy()                                   # [B, MF] active and full
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin)[:, :-1][np.broadcast_to(act[:, None], fin[:, :-1].shape)].all()
    err = np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0))
    for lo, hi in K7_GROUPS:
        scale = np.where(fin[:, lo:hi], np.abs(want[:, lo:hi]), 0.0).max(axis=1)      # [B, MF]
        ok = err[:, lo:hi].max(axis=1) <= K7_TOL * np.maximum(scale, 1e-30)
        assert ok[act].all(), (case, lo, hi)
    # the selection outside the kernel, as the JAX batch step makes it
    gs, gi = stable_top_k(torch.as_tensor(got[:, O_SCORE]), NSEL)
    ws, wi = jax.vmap(lambda s: jax.lax.top_k(s, NSEL))(jnp.asarray(want[:, O_SCORE]))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi), err_msg=case)
    np.testing.assert_array_equal(gs.numpy() > -np.inf, np.asarray(ws) > -np.inf)
    if case == "all_invisible":
        assert np.isneginf(want[:, O_SCORE]).all() and (gi.numpy() == np.arange(NSEL)).all()
    if case == "equal_scores":
        assert (np.asarray(wi) == np.arange(NSEL)).all()
    if case.startswith("real"):
        assert (want[:, O_SCORE] > -np.inf).sum() >= 4 * len(LANES)


def test_stable_top_k_orders_ties_and_nan_as_lax_top_k():
    """Equal scores go lowest index first, and a NaN score (a degenerate S)
    ranks ahead of every number, as in XLA's total order: the JAX batch step
    then drops it with top_score > -inf, and so does the port's."""
    s = np.array([[1.0, np.nan, 3.0, -np.inf, 3.0, -np.inf, np.nan, 0.5],
                  [0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                  [-np.inf] * 8], np.float32)
    for k in (1, 3, 6, 8):
        gv, gi = stable_top_k(torch.as_tensor(s), k)
        wv, wi = jax.vmap(lambda r: jax.lax.top_k(r, k))(jnp.asarray(s))
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    gv, gi = stable_top_k(torch.as_tensor(s[:1]), 4)
    assert gi.tolist() == [[1, 6, 2, 4]] and (gv[0, :2] > -np.inf).sum() == 0
    # the partial-slot pick: the first set flag, else slot 0
    flags = torch.tensor([[0.0, 1.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0]])
    pv, pi = stable_top_k(flags, 1)
    assert pi.tolist() == [[1], [0]] and (pv > 0).tolist() == [[True], [False]]


# ---------------------------------------------------------------------- K9


def _k9_scene(case, batch_inputs):
    g = np.random.default_rng(41)
    hh, ww = (480, 640) if case == "large" else (H, W)
    if case.startswith("real"):
        a = batch_inputs[0][("score_map", int(case[4:]))][0]
        return a[0], a[1]
    img = g.integers(0, 256, (hh, ww), dtype=np.uint8)
    patch = img[40:40 + B, 70:70 + B]
    if case == "flat_image":
        img = np.full((hh, ww), 117, np.uint8)
    elif case == "flat_patch":
        patch = np.full((B, B), 90, np.uint8)
    elif case == "low_sigma":
        img = g.integers(100, 108, (hh, ww), dtype=np.uint8)      # image sigma below 10
    frames = torch.tensor(np.ascontiguousarray(img))[None]
    rows = st.patch_row(torch.tensor(np.ascontiguousarray(patch)))[None, None]
    return frames, rows


@pytest.mark.parametrize("banded", [False, True], ids=["whole", "banded"])
@pytest.mark.parametrize("case", ["real12", "random", "flat_image", "flat_patch", "low_sigma", "large"])
def test_k9_plain_matches_pallas(case, banded, batch_inputs):
    frames, rows = _k9_scene(case, batch_inputs)
    hh, ww = frames.shape[-2:]
    c = dataclasses.replace(SMC, H=hh, W=ww)
    got = score_map_plain(frames, rows, c).numpy()
    assert got.shape == (frames.shape[0], rows.shape[1], hh, ww)
    for b in range(frames.shape[0]):
        want = np.asarray(pallas_score_maps(
            jnp.asarray(frames[b].numpy()), None, boxsize=B, corr_sigma_thresh=c.corr_sigma_thresh,
            low_sigma_penalty=c.low_sigma_penalty, interpret=True, force_banded=banded,
            patch_rows=jnp.asarray(rows[b].numpy())))
        miss = want == MISS
        np.testing.assert_array_equal(got[b] == MISS, miss, err_msg=case)
        half = (B - 1) // 2
        assert not miss[:, half:hh - half, half:ww - half].any() and miss[:, :half].all()
        if case == "flat_image":        # zero image variance: 1, plus the low-sigma penalty
            assert (got[b][~miss] == 1.0 + c.low_sigma_penalty).all()
            continue
        if case == "flat_patch":        # zero patch variance: 1, no penalty on a textured image
            assert (got[b][~miss] == 1.0).all()
            continue
        # a low-contrast window's variance is the difference of two numbers some 2,000 times
        # larger, so its f32 rounding reaches 5e-4 of the score: that case is held to 1e-3
        tol = 1e-3 if case == "low_sigma" else MAP_RTOL
        np.testing.assert_allclose(got[b][~miss], want[~miss], rtol=tol, atol=MAP_ATOL, err_msg=case)
        # the penalty is a step of 5 on scores of at most ~4: the same cells carry it
        np.testing.assert_array_equal((got[b] >= 4.5) & ~miss, (want >= 4.5) & ~miss)
        if case == "low_sigma":
            assert ((want >= 4.5) & ~miss).sum() == (~miss).sum()


# ---------------------------------------------------------------------- K10


def _k10_inputs(batch_inputs, t):
    shared, slot_rows, lam, _c = batch_inputs[0][("particle_predict", t)][0]
    return shared, slot_rows, lam


@pytest.mark.parametrize("which", ["fresh_ray", "conversion"])
def test_k10_plain_matches_pallas(which, batch_inputs):
    if which == "fresh_ray":
        t = _frame_with(batch_inputs, lambda a, o: bool((a[5][:, 0] & (a[7][:, 0] == 2)).any()))
    else:
        t = _frame_with(batch_inputs, lambda a, o: bool(o.did_convert.any()))
    shared, slot_rows, lam = _k10_inputs(batch_inputs, t)
    got = particle_predict_plain(shared, slot_rows, lam, PCN).numpy()
    assert got.shape == (len(LANES), 1, 8, 128)
    for b in range(len(LANES)):
        sl = slot_rows[b].numpy()
        raw = pallas_particle_predict_fused(
            jnp.asarray(sl[:, :6]), jnp.pad(jnp.asarray(sl[:, 6:48]).reshape(1, 7, 6), ((0, 0), (0, 6), (0, 0))),
            jnp.asarray(sl[:, 48:]).reshape(1, 6, 6), jnp.asarray(shared[b, :7].numpy()),
            jnp.asarray(shared[b, 7:].numpy()).reshape(7, 7), jnp.asarray(lam[b].numpy()),
            fku=CAM[0], fkv=CAM[1], u0c=CAM[2], v0c=CAM[3], kd1=CAM[4], sd0=P_STD.cam_sd,
            no_sigma=P_STD.no_sigma, interpret=True, return_raw=True)[-1]
        want = np.asarray(raw)
        assert want.shape == (1, 8, 128)
        fin = np.isfinite(want)
        assert (np.isfinite(got[b]) == fin).all()
        scale = np.where(fin, np.abs(want), 0.0).max(axis=-1, keepdims=True)
        err = np.where(fin, np.abs(got[b] - want), 0.0)
        assert (err <= ROW_TOL_K10 * np.maximum(scale, 1e-30)).all(), (which, b)


def _k4_args_of_lane(batch_inputs, t, b):
    """The single-stream K4 call that serves lane b's partial slot of the
    batch step at frame t: a one-row state (the slot's rows, pidx 0)."""
    store, _ = batch_inputs
    frames, patch_rows, _c = store[("score_map", t)][0]
    shared, slot_rows, lam = _k10_inputs(batch_inputs, t)
    _maps, _pred, prob, lam_c, palive, making, pmask, ma, _sbc = store[("search_bayes_maps", t)][0]
    return (frames[b], prob[b], lam_c[b], palive[b], making[b], pmask[b], ma[b],
            torch.zeros(1, dtype=torch.int32), patch_rows[b, 0], shared[b], slot_rows[b, 0], SBC)


@pytest.mark.parametrize("which", ["fresh_ray", "conversion", "no_partial"])
def test_k10_and_k11_plain_equal_the_k4_twin_exactly(which, batch_inputs):
    """K10 writes exactly the rows K4's merged mode produces for the slot,
    and K11 given K9's map returns exactly K4's results: prob, palive, the
    moments, the decisions, found, z, best and the overflow count."""
    pick = {
        "fresh_ray": lambda a, o: bool((a[5][:, 0] & (a[7][:, 0] == 2)).any()),
        "conversion": lambda a, o: bool(o.did_convert.any()),
        "no_partial": lambda a, o: bool((~a[6][:, 0]).any() and a[5].any()),
    }[which]
    t = _frame_with(batch_inputs, pick)
    store, _ = batch_inputs
    a9 = store[("score_map", t)][0]
    a11 = store[("search_bayes_maps", t)][0]
    maps = score_map_plain(a9[0], a9[1], SMC)
    pred = particle_predict_plain(*_k10_inputs(batch_inputs, t), PCN)
    assert torch.equal(maps, a11[0]) and torch.equal(pred, a11[1])
    k11 = search_bayes_maps_plain(*a11)
    for b in range(len(LANES)):
        k4 = search_bayes_plain(*_k4_args_of_lane(batch_inputs, t, b))
        assert torch.equal(k4[10][0], pred[b, 0, :, :NP]), (which, b)
        for name, g, w in zip(("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found",
                               "z", "best"), k11, k4[:10]):
            np.testing.assert_array_equal(g[b].numpy(), w.numpy(), err_msg=f"{which} lane {b}: {name}")
    if which == "conversion":
        assert bool(k11[4].any())
    if which == "no_partial":
        none = ~a11[6][:, 0]
        assert not k11[7][none].any() and not k11[4][none].any()


# ---------------------------------------------------------------------- K11


def _k11_torch(s, pred):
    t = lambda a, **k: torch.as_tensor(np.asarray(a), **k)   # noqa: E731
    c = dataclasses.replace(SBC, win_radius=s["win_radius"], corr_thresh2=0.40, no_sigma=3.0)
    return search_bayes_maps_plain(
        t(s["corr"])[None], t(pred)[None], t(s["prob"])[None], t(s["lam"])[None], t(s["palive"])[None],
        t(s["making"])[None], t(s["pmask"])[None], t(s["attempts"])[None], c)


@pytest.mark.parametrize("name,kw", SB_CASES, ids=[c[0] for c in SB_CASES])
def test_k11_plain_matches_pallas_on_the_jax_suite_scenes(name, kw):
    import zlib

    s = _scenario(zlib.crc32(name.encode()) % 100000, **kw)
    want = [np.asarray(r) for r in _fused(s)]
    pred = _pred_rows(np.asarray(s["hpi"]), np.asarray(s["sinv"]), np.asarray(s["dets"]), 128)
    got = [r[0].numpy() for r in _k11_torch(s, pred)]
    names = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")
    for n, g, w in zip(names, got, want):
        if n in ("prob", "mean", "cov"):
            np.testing.assert_allclose(g, w, rtol=PROB_RTOL, atol=PROB_RTOL * np.abs(w).max(),
                                       err_msg=f"{name}: {n}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{name}: {n}")
    if name == "not_making":
        assert not want[7].any()
    else:
        assert want[7].any()


@pytest.mark.parametrize("which", ["fresh_ray", "conversion"])
def test_k11_plain_matches_pallas_on_real_frames(which, batch_inputs):
    if which == "fresh_ray":
        t = _frame_with(batch_inputs, lambda a, o: bool((a[5][:, 0] & (a[7][:, 0] == 2)).any()))
    else:
        t = _frame_with(batch_inputs, lambda a, o: bool(o.did_convert.any()))
    a11 = batch_inputs[0][("search_bayes_maps", t)][0]
    got = search_bayes_maps_plain(*a11)
    j = lambda x: jnp.asarray(x.numpy())   # noqa: E731
    for b in range(len(LANES)):
        want = pallas_search_bayes(
            j(a11[0][b]), j(a11[1][b]), j(a11[2][b]), j(a11[3][b]), j(a11[4][b]), j(a11[5][b]),
            j(a11[6][b]), j(a11[7][b]), image_shape=(H, W), win_radius=SBC.win_radius,
            no_sigma=SBC.no_sigma, corr_thresh2=SBC.corr_thresh2,
            prune_prob_thresh=P_STD.prune_prob_thresh, sd_depth_ratio=P_STD.sd_depth_ratio,
            min_particles=P_STD.min_particles,
            erase_partial_after_attempts=P_STD.erase_partial_after_attempts, interpret=True)
        names = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")
        mean2 = float(np.asarray(want[2]).max()) ** 2       # cov = E[lambda^2] - mean^2 cancels
        for n, g, w in zip(names, got, want):
            g, w = g[b].numpy(), np.asarray(w)
            if n in ("prob", "mean", "cov"):
                atol = PROB_RTOL * (mean2 if n == "cov" else np.abs(w).max())
                np.testing.assert_allclose(g, w, rtol=PROB_RTOL, atol=atol,
                                           err_msg=f"{which} lane {b}: {n}")
            else:
                np.testing.assert_array_equal(g, w, err_msg=f"{which} lane {b}: {n}")


def test_batch_wrappers_route_cpu_tensors_to_the_plain_versions(batch_inputs):
    a = batch_inputs[0][("measure_select", 5)][0]
    _build.reset_launches()
    for g, w in zip(measure_select(*a, rows=True), measure_select_plain(*a, rows=True)):
        assert torch.equal(g, w)
    assert all(v == 0 for v in _build.launches.values())
