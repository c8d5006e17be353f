"""The plain versions of K9, K10, K11, K12 and K13 at two partial slots a
lane (F = 2, max_features_to_init_at_once = 2) against the JAX Pallas
kernels they port, run in interpret mode in this process.

The inputs are what the port's own CPU batch replay hands each wrapper on
real frames where both partial slots of a lane are searched (lanes 0 and 1
of the bench_batch64 recipe at config "maxp2", 16 frames, on the default
route for K9-K11 and on route "sb0" for K12 and K13), and seeded variants
of them. At F = 2 the JAX single stream builds its maps with
pallas_score_maps(return_padded=True) and reads them in pallas_search_bayes's
compact mode with corr_padded=True (scenelib2_tpu/runtime/step.py:598-608,
1120-1134); the port's K9 writes unpadded maps, which K11 reads as
corr_padded=False would.

Tolerances are those of the F = 1 tests (tests/test_torch_batch_kernels.py,
tests/test_torch_batch_route_kernels.py): integers, masks and decisions
exactly; K9's valid cells within 2e-5 absolute plus 2e-5 relative of the
padded map's interior, its invalid cells exactly 1e6 and the same set; K10's
rows within 1e-4 of each row's largest entry; K11's and K12's probabilities
and moments within 1e-5 relative (the depth variance within 1e-5 of the
squared mean); K13 exactly.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_bayes import pallas_bayes_update
from scenelib2_tpu.kernels.pallas_particle import pallas_particle_predict_fused
from scenelib2_tpu.kernels.pallas_particle_search import pallas_multi_ellipse_search
from scenelib2_tpu.kernels.pallas_score_map import pallas_score_maps
from scenelib2_tpu.kernels.pallas_search_bayes import pallas_search_bayes
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.kernels.bayes import BayesConsts, bayes_update_plain
from scenelib2_torch.kernels.particle import ParticleConsts, particle_predict_plain
from scenelib2_torch.kernels.particle_search import ParticleSearchConsts, particle_search_plain
from scenelib2_torch.kernels.score_map import MISS, ScoreMapConsts, score_map_plain
from scenelib2_torch.kernels.search_bayes import SearchBayesConsts, search_bayes_maps_plain
from scenelib2_torch.parallel.mesh import make_batched_step

LANES = (0, 1)
N_STEPS = 16
MAP_ATOL = MAP_RTOL = 2e-5
ROW_TOL = 1e-4
PROB_RTOL = 1e-5
WRAPPERS = ("score_map", "particle_predict", "search_bayes_maps", "particle_search", "bayes_update")
SB_NAMES = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@contextlib.contextmanager
def _capture(store: dict, frame_no: list):
    """Record the arguments of the batch step's stage-8 wrappers, by frame."""
    import scenelib2_torch.runtime.step as step_mod

    orig = {n: getattr(step_mod, n) for n in WRAPPERS}

    def keep(v):   # the score maps live in the step's workspace
        return v.clone() if isinstance(v, torch.Tensor) else v

    def wrap(n):
        def call(*a, **k):
            store[(n, frame_no[0])] = (tuple(keep(v) for v in a), {x: keep(v) for x, v in k.items()})
            return orig[n](*a, **k)
        return call

    for n in WRAPPERS:
        setattr(step_mod, n, wrap(n))
    try:
        yield
    finally:
        for n in WRAPPERS:
            setattr(step_mod, n, orig[n])


@pytest.fixture(scope="module")
def maxp_inputs(tmp_path_factory):
    """{route: (wrapper inputs by (name, output index), params)} of the
    port's CPU replays of lanes 0 and 1 at config "maxp2" on the default
    route and on route sb0, mapping on."""
    params, states0, frames = make_lanes(str(tmp_path_factory.mktemp("lanes")), n_frames=N_STEPS + 2,
                                         device="cpu", dtype=torch.float32, lanes=LANES, config="maxp2")
    assert params.max_features_to_init_at_once == 2
    res = {}
    for route, sb in (("default", None), ("sb0", False)):
        store, frame_no = {}, [0]
        with _capture(store, frame_no):
            step = make_batched_step(params, device="cpu", batch_sb=sb)
            states = states0
            for t in range(N_STEPS):
                frame_no[0] = t
                states, _o = step(states, torch.as_tensor(frames[t]), True)
        res[route] = store
    return res, params


def _both_making(store, name, making_of):
    """The captured output indices at which some lane searches both slots."""
    ts = sorted(t for (n, t) in store if n == name and bool(making_of(store[(n, t)]).all(-1).any()))
    assert ts, f"no captured {name} call searches both partial slots of a lane"
    return ts


def _k11_frames(maxp_inputs):
    store = maxp_inputs[0]["default"]
    return _both_making(store, "search_bayes_maps", lambda c: c[0][5])


# ---------------------------------------------------------------------- K9


@pytest.mark.parametrize("case", ["real", "seeded"])
def test_k9_two_slots_plain_equals_the_padded_pallas_maps_interior(case, maxp_inputs):
    _store, params = maxp_inputs
    smc = ScoreMapConsts.from_params(params)
    t = _k11_frames(maxp_inputs)[0]
    frames, rows, _c = maxp_inputs[0]["default"][("score_map", t)][0]
    if case == "seeded":
        g = np.random.default_rng(92)
        frames = torch.tensor(g.integers(0, 256, tuple(frames.shape), dtype=np.uint8))
        rows = rows.flip(1)                    # the two slots' patches swapped
    assert rows.shape == (len(LANES), 2, 128)
    got = score_map_plain(frames, rows, smc).numpy()
    assert got.shape == (len(LANES), 2, smc.H, smc.W)
    for b in range(len(LANES)):
        padded = np.asarray(pallas_score_maps(
            j(frames[b]), None, boxsize=smc.boxsize, corr_sigma_thresh=smc.corr_sigma_thresh,
            low_sigma_penalty=smc.low_sigma_penalty, interpret=True, patch_rows=j(rows[b]),
            return_padded=True))
        assert padded.shape[0] == 2 and padded.shape[1:] >= (smc.H, smc.W)
        want = padded[:, : smc.H, : smc.W]
        miss = want == MISS
        np.testing.assert_array_equal(got[b] == MISS, miss, err_msg=f"{case} lane {b}")
        np.testing.assert_allclose(got[b][~miss], want[~miss], rtol=MAP_RTOL, atol=MAP_ATOL,
                                   err_msg=f"{case} lane {b}")


# ---------------------------------------------------------------------- K10


def _k10_jax(shared, slot_rows, lam, params):
    """pallas_particle_predict_fused's raw rows [F, 8, 128] for one lane's F slots."""
    F = slot_rows.shape[0]
    sl = slot_rows.numpy()
    return np.asarray(pallas_particle_predict_fused(
        jnp.asarray(sl[:, :6]), jnp.pad(jnp.asarray(sl[:, 6:48]).reshape(F, 7, 6), ((0, 0), (0, 6), (0, 0))),
        jnp.asarray(sl[:, 48:]).reshape(F, 6, 6), j(shared[:7]), j(shared[7:]).reshape(7, 7), j(lam),
        fku=params.cam_fku, fkv=params.cam_fkv, u0c=params.cam_u0, v0c=params.cam_v0, kd1=params.cam_kd1,
        sd0=params.cam_sd, no_sigma=params.no_sigma, interpret=True, return_raw=True)[-1])


@pytest.mark.parametrize("case", ["real", "seeded"])
def test_k10_two_slots_plain_matches_pallas(case, maxp_inputs):
    store, params = maxp_inputs
    pcn = ParticleConsts.from_params(params)
    t = _k11_frames(maxp_inputs)[0]
    shared, slot_rows, lam, _c = store["default"][("particle_predict", t)][0]
    if case == "seeded":                       # other depths on both slots
        g = np.random.default_rng(93)
        lam = torch.tensor(g.uniform(0.3, 6.0, tuple(lam.shape)), dtype=torch.float32)
    assert slot_rows.shape[:2] == (len(LANES), 2)
    got = particle_predict_plain(shared, slot_rows, lam, pcn).numpy()
    assert got.shape == (len(LANES), 2, 8, 128)
    for b in range(len(LANES)):
        want = _k10_jax(shared[b], slot_rows[b], lam[b], params)
        assert want.shape == (2, 8, 128)
        fin = np.isfinite(want)
        assert (np.isfinite(got[b]) == fin).all()
        scale = np.where(fin, np.abs(want), 0.0).max(axis=-1, keepdims=True)
        err = np.where(fin, np.abs(got[b] - want), 0.0)
        assert (err <= ROW_TOL * np.maximum(scale, 1e-30)).all(), (case, b)


# ---------------------------------------------------------------------- K11


def _compare_sb(got, want, what):
    mean2 = float(np.abs(np.asarray(want[2])).max()) ** 2          # cov = E[lambda^2] - mean^2 cancels
    for n, g, w in zip(SB_NAMES, got, want):
        g, w = g.numpy(), np.asarray(w)
        if n in ("prob", "mean", "cov"):
            atol = PROB_RTOL * (mean2 if n == "cov" else max(float(np.abs(w).max()), 1e-30))
            np.testing.assert_allclose(g, w, rtol=PROB_RTOL, atol=atol, err_msg=f"{what}: {n}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {n}")


@pytest.mark.parametrize("case", ["real", "slot1_only", "seeded_alive"])
def test_k11_two_slots_plain_matches_pallas_compact_mode_on_padded_maps(case, maxp_inputs):
    store, params = maxp_inputs
    sbc = SearchBayesConsts.from_params(params)
    t = _k11_frames(maxp_inputs)[0]
    a = list(store["default"][("search_bayes_maps", t)][0][:8])
    if case == "slot1_only":                   # the first slot not measurable this frame
        a[5] = a[5].clone()
        a[5][:, 0] = False
    elif case == "seeded_alive":
        g = np.random.default_rng(94)
        a[4] = torch.tensor(g.uniform(size=tuple(a[4].shape)) > 0.3)
        a[2] = torch.tensor(g.uniform(0.0, 0.02, tuple(a[2].shape)), dtype=torch.float32)
    got = search_bayes_maps_plain(*a, sbc)
    H, W = params.cam_height, params.cam_width
    hp, wp = -(-H // 8) * 8, -(-W // 128) * 128
    for b in range(len(LANES)):
        # the maps as pallas_score_maps(return_padded=True) hands them over:
        # cells beyond H, W hold 1e6
        padded = np.full((2, hp, wp), MISS, np.float32)
        padded[:, :H, :W] = a[0][b].numpy()
        want = pallas_search_bayes(
            jnp.asarray(padded), j(a[1][b]), j(a[2][b]), j(a[3][b]), j(a[4][b]), j(a[5][b]), j(a[6][b]),
            j(a[7][b]), corr_padded=True, image_shape=(H, W), win_radius=sbc.win_radius,
            no_sigma=sbc.no_sigma, corr_thresh2=sbc.corr_thresh2,
            prune_prob_thresh=params.prune_prob_thresh, sd_depth_ratio=params.sd_depth_ratio,
            min_particles=params.min_particles,
            erase_partial_after_attempts=params.erase_partial_after_attempts, interpret=True)
        _compare_sb([g[b] for g in got], want, f"{case} lane {b}")
    if case == "real":
        assert bool(got[7].reshape(len(LANES), 2, -1).any(-1).all(-1).any())   # both slots found matches


# ---------------------------------------------------------------------- K12, K13 (route sb0)


def test_k13_two_slots_plain_matches_pallas(maxp_inputs):
    store, params = maxp_inputs
    psc = ParticleSearchConsts.from_params(params)
    ts = _both_making(store["sb0"], "particle_search", lambda c: c[0][3].any(-1))
    for t in ts[:2]:
        maps, h, sinv, alive = store["sb0"][("particle_search", t)][0][:4]
        assert maps.shape[:2] == (len(LANES), 2)
        got = particle_search_plain(maps, h, sinv, alive, psc)
        Fl = maps.shape[0] * maps.shape[1]
        flat = [x.reshape(Fl, *x.shape[2:]) for x in (maps, h, sinv, alive)]
        want = pallas_multi_ellipse_search(*(j(x) for x in flat), win_radius=psc.win_radius,
                                           no_sigma=psc.no_sigma, corr_thresh2=psc.corr_thresh2, interpret=True)
        for n, g, w in zip(("found", "u", "v", "over"), got, want):
            np.testing.assert_array_equal(g.reshape(Fl, -1).numpy(), np.asarray(w), err_msg=f"K13 {n} at {t}")


@pytest.mark.parametrize("case", ["real", "sell_by"])
def test_k12_two_slots_plain_matches_pallas_on_k10_rows(case, maxp_inputs):
    store, params = maxp_inputs
    bc = BayesConsts.from_params(params)
    t = _both_making(store["sb0"], "bayes_update", lambda c: c[0][9])[0]
    a, k = store["sb0"][("bayes_update", t)]
    pred = k["pred_rows"]
    assert pred.shape[:2] == (len(LANES), 2)
    flat = [None if x is None else x.reshape(-1, *x.shape[2:]) for x in a[:12]]
    pred = pred.reshape(-1, *pred.shape[2:])
    if case == "sell_by":
        flat[11] = torch.full_like(flat[11], params.erase_partial_after_attempts + 1)
        flat[10] = torch.ones_like(flat[10])
    got = bayes_update_plain(*flat, bc, pred_rows=pred)
    zeros = torch.zeros(flat[0].shape)
    want = pallas_bayes_update(
        j(flat[0]), j(flat[1]), j(flat[2]), j(flat[3]), j(flat[4]), j(flat[5]), j(torch.zeros(zeros.shape + (2,))),
        j(torch.zeros(zeros.shape + (2, 2))), j(zeros), j(flat[9]), j(flat[10]), j(flat[11]),
        prune_prob_thresh=params.prune_prob_thresh, sd_depth_ratio=params.sd_depth_ratio,
        min_particles=params.min_particles, erase_partial_after_attempts=params.erase_partial_after_attempts,
        interpret=True, pred_rows=j(pred))
    _compare_sb(got, want, f"K12 {case}")
    if case == "sell_by":
        assert np.asarray(want[5])[~np.asarray(want[4])].all()
