"""The plain versions of K8, K12 and K13, and the tensor-op forms of the
route with batch_pallas=False, against the JAX package.

Each plain PyTorch version (what CPU tensors run through the kernel wrapper)
is held against its TPU kernel run in Pallas interpret mode in this process
(pallas_search.py::pallas_elliptical_search for K8,
pallas_bayes.py::pallas_bayes_update for K12 in both row forms,
pallas_particle_search.py::pallas_multi_ellipse_search for K13), on the
inputs that the port's own CPU replays of the two routes hand each wrapper
on real frames (four lanes: two textures x two phase offsets, 22 frames)
and on built cases: a tie and an overflowing ellipse (K8); an all-zero
likelihood and a sell-by (K12); a degenerate S (NaN, huge and indefinite
S^-1, a centre far off the frame), an empty region and a tie (K13).

The route's XLA forms are held to the JAX package's functions in its fast
mode (f32: jax.enable_x64(False)): correlate.frame_sums, cross_sum_maps and
patch_stats exactly (integer sums), the penalized score map within 2e-5
absolute plus 2e-5 relative (K9's bar: XLA may contract the NSSD formula's
products into fused multiply-adds on the CPU), gather_windows_u8 exactly,
multi_ellipse_search_dense exactly (its window form against JAX's dense
masks, degenerate S included), and JAX's XLA Shi-Tomasi pick against
K6's plain version over lanes (which the route runs in its place) on real
frames: the pick exactly, its eigenvalue within 1e-6 relative.

Tolerances: integers, masks and decisions exactly. K8's best within 2e-5
absolute (K2's bar). K12's probabilities and moments within 1e-5 relative,
the depth variance within 1e-5 of the squared mean (K11's bars). K13 and
the dense search exactly. On the same rows the route's pair K13 + K12
decides and rounds exactly as K11.
"""

from __future__ import annotations

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_tpu.kernels import shi_tomasi as jst
from scenelib2_tpu.kernels.pallas_bayes import pallas_bayes_update
from scenelib2_tpu.kernels.pallas_particle_search import pallas_multi_ellipse_search
from scenelib2_tpu.kernels.pallas_search import gather_windows_u8, pallas_elliptical_search
from scenelib2_torch.config import Params
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.bayes import BayesConsts, bayes_update_plain
from scenelib2_torch.kernels.particle_search import (
    ParticleSearchConsts,
    particle_search_plain,
    region_cells,
    region_geometry,
)
from scenelib2_torch.kernels.search import SearchConsts, search_window_origin, search_windows_plain
from scenelib2_torch.kernels.search_bayes import SearchBayesConsts, search_bayes_maps_plain
from scenelib2_torch.kernels.shi_tomasi import shi_tomasi_plain
from scenelib2_torch.parallel.mesh import make_batched_step

P_STD = dataclasses.replace(Params(), max_features=16)
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize
NP = P_STD.n_particles
SC = SearchConsts.from_params(P_STD)
BC = BayesConsts.from_params(P_STD)
PSC = ParticleSearchConsts.from_params(P_STD)
SBC = SearchBayesConsts.from_params(P_STD)
LANES = (0, 1, 32, 33)
N_STEPS = 22
K8_BEST_ATOL = 2e-5
PROB_RTOL = 1e-5
MAP_ATOL = MAP_RTOL = 2e-5
EV_RTOL = 1e-6
WRAPPERS = ("search_windows", "bayes_update", "particle_search", "search_bayes_maps",
            "shi_tomasi_plain", "shi_tomasi")


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
    """Record the arguments of the batch step's wrappers, by frame."""
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
def route_inputs(tmp_path_factory):
    """{route: (wrapper inputs by (name, output index), outputs, frames)} of
    the port's CPU replays of lanes 0, 1, 32, 33 on routes bp0 and sb0,
    mapping on."""
    params, states0, frames = make_lanes(str(tmp_path_factory.mktemp("lanes")), n_frames=N_STEPS + 2,
                                         device="cpu", dtype=torch.float32, lanes=LANES)
    res = {}
    for route, pr, sb in (("bp0", dataclasses.replace(params, batch_pallas=False), None),
                          ("sb0", params, False)):
        store, frame_no, outs = {}, [0], []
        with _capture(store, frame_no):
            step = make_batched_step(pr, device="cpu", batch_sb=sb)
            states = states0
            for t in range(N_STEPS):
                frame_no[0] = t
                states, o = step(states, torch.as_tensor(frames[t]), True)
                outs.append(o)
        res[route] = (store, outs, frames)
    return res


def _frames_where(store, name, pred):
    ts = [t for (n, t) in store if n == name and pred(store[(n, t)][0])]
    assert ts, f"no captured frame of {name} has the wanted case"
    return ts


# ---------------------------------------------------------------------- K8


def _k8_jax(args):
    windows, patches, u0, v0, h, abc, active = args
    sinv = torch.stack([abc[:, 0], abc[:, 1], abc[:, 1], abc[:, 2]], -1).reshape(-1, 2, 2)
    return pallas_elliptical_search(
        j(windows), j(patches), j(u0), j(v0), j(h), j(sinv), j(active), image_shape=(H, W),
        boxsize=B, win_radius=SC.win_radius, no_sigma=SC.no_sigma, corr_thresh2=SC.corr_thresh2,
        corr_sigma_thresh=SC.corr_sigma_thresh, interpret=True)


def _k8_built(case, rng):
    """Four features on a random frame: a patch planted twice in the first
    window (two perfect matches: the later one in u-outer / v-inner order
    wins) or a near-singular S^-1 (an ellipse far beyond the window)."""
    frame = torch.tensor(rng.integers(0, 256, (1, H, W), dtype=np.uint8))
    h = torch.tensor([[[100.0, 90.0], [200.0, 150.0], [60.2, 180.7], [250.4, 40.6]]])
    abc = torch.tensor([[[0.02, 0.002, 0.03]] * 4])
    patches = torch.tensor(rng.integers(0, 256, (1, 4, B, B), dtype=np.uint8))
    if case == "tie":
        for (uu, vv) in ((92, 80), (110, 98)):
            frame[0, vv - 5 : vv + 6, uu - 5 : uu + 6] = patches[0, 0]
    else:
        abc[0, 1] = torch.tensor([1e-4, 0.0, 1e-4])
    u0, v0, _, _ = search_window_origin(h, SC.win_radius, W, H, B)
    windows = correlate.gather_windows_u8(frame, u0, v0, SC.win_radius, B)
    return (windows[0], patches[0], u0[0], v0[0], h[0], abc[0], torch.ones(4, dtype=torch.bool))


@pytest.mark.parametrize("case", ["real", "tie", "overflow"])
def test_k8_plain_matches_pallas(case, route_inputs):
    store = route_inputs["bp0"][0]
    if case == "real":
        ts = _frames_where(store, "search_windows", lambda a: bool(a[6].any()))
        calls = [tuple(t.reshape(-1, *t.shape[2:]) for t in store[("search_windows", t)][0][:7])
                 for t in ts[:: max(1, len(ts) // 3)]]
    else:
        calls = [_k8_built(case, np.random.default_rng(8))]
    for args in calls:
        got = search_windows_plain(*args, SC)
        want = [np.asarray(w) for w in _k8_jax(args)]
        for n, g, w in zip(("found", "u", "v", "best", "over"), got, want):
            if n == "best":
                np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=K8_BEST_ATOL, err_msg=n)
            else:
                np.testing.assert_array_equal(g.numpy(), w, err_msg=n)
        if case == "tie":
            assert bool(got[0][0]) and (int(got[1][0]), int(got[2][0])) == (110, 98)
        if case == "overflow":
            assert bool(got[4][1]) and not bool(got[4][0])


def test_gather_windows_matches_jax(route_inputs):
    store, _outs, frames = route_inputs["bp0"]
    windows, _p, u0, v0 = store[("search_windows", 5)][0][:4]
    for b in range(len(LANES)):
        want = gather_windows_u8(j(torch.as_tensor(frames[5][b])), j(u0[b]), j(v0[b]), SC.win_radius, B)
        np.testing.assert_array_equal(windows[b].numpy(), np.asarray(want))


# ---------------------------------------------------------------------- K12


def _k12_jax(args, pred):
    (prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask, ma) = args[:12]
    if pred is not None:
        hpi = torch.zeros(prob.shape + (2,))
        sinv = torch.zeros(prob.shape + (2, 2))
        dets = torch.zeros(prob.shape)
    return pallas_bayes_update(
        j(prob), j(lam), j(palive), j(found), j(p_over), j(z), j(hpi), j(sinv), j(dets), j(making),
        j(pmask), j(ma), prune_prob_thresh=P_STD.prune_prob_thresh,
        sd_depth_ratio=P_STD.sd_depth_ratio, min_particles=P_STD.min_particles,
        erase_partial_after_attempts=P_STD.erase_partial_after_attempts, interpret=True,
        pred_rows=None if pred is None else j(pred))


def _k12_rows(route_inputs, form, case):
    """The K12 rows [F, ...] of a captured call (lanes x slots flattened)."""
    store = route_inputs["bp0" if form == "rows13" else "sb0"][0]
    ts = _frames_where(store, "bayes_update", lambda a: bool(a[9].any()))
    a, k = store[("bayes_update", ts[len(ts) // 2])]
    pred = k.get("pred_rows")
    flat = [None if t is None else t.reshape(-1, *t.shape[2:]) for t in a[:12]]
    pred = None if pred is None else pred.reshape(-1, *pred.shape[2:])
    if case == "all_zero":
        flat[3] = torch.zeros_like(flat[3])                      # nothing found, nothing overflowed
        flat[4] = torch.zeros_like(flat[4])
        flat[9] = torch.ones_like(flat[9])
    elif case == "sell_by":
        flat[11] = torch.full_like(flat[11], P_STD.erase_partial_after_attempts + 1)
        flat[10] = torch.ones_like(flat[10])
    return flat, pred


@pytest.mark.parametrize("case", ["real", "all_zero", "sell_by"])
@pytest.mark.parametrize("form", ["rows13", "pred_rows"])
def test_k12_plain_matches_pallas(form, case, route_inputs):
    flat, pred = _k12_rows(route_inputs, form, case)
    got = bayes_update_plain(*flat, BC, pred_rows=pred)
    want = [np.asarray(w) for w in _k12_jax(flat, pred)]
    mean2 = float(np.abs(want[2]).max()) ** 2
    for n, g, w in zip(("prob", "palive", "mean", "cov", "convert", "kill", "n_over"), got, want):
        if n in ("prob", "mean", "cov"):
            atol = PROB_RTOL * (mean2 if n == "cov" else max(float(np.abs(w).max()), 1e-30))
            np.testing.assert_allclose(g.numpy(), w, rtol=PROB_RTOL, atol=atol, err_msg=n)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=n)
    if case == "all_zero":
        making = flat[9].numpy()
        assert want[5][making & (flat[2].numpy().any(-1))].all()          # every making row dies
    if case == "sell_by":
        assert want[5][~want[4]].all()


def test_k13_k12_pair_equals_k11_on_the_same_rows(route_inputs):
    """Route sb0's pair decides and rounds as the default route's K11 on
    the same maps and prediction rows (every float exactly)."""
    store = route_inputs["sb0"][0]
    ts = _frames_where(store, "bayes_update", lambda a: bool(a[9].any()))
    assert len(ts) >= 3
    for t in ts:
        a13, _ = store[("particle_search", t)]
        a12, k12 = store[("bayes_update", t)]
        maps, pred = a13[0], k12["pred_rows"]
        prob, lam, palive, making, pmask, ma = a12[0], a12[1], a12[2], a12[9], a12[10], a12[11]
        k11 = search_bayes_maps_plain(maps, pred, prob, lam, palive, making, pmask, ma, SBC)
        found, zu, zv, p_over = particle_search_plain(*a13[:4], PSC)
        z = torch.stack([zu, zv], -1).to(torch.float32)
        pair = bayes_update_plain(*(x.reshape(-1, *x.shape[2:]) for x in (prob, lam, palive, found, p_over, z)),
                                  None, None, None, making.reshape(-1), pmask.reshape(-1), ma.reshape(-1),
                                  BC, pred_rows=pred.reshape(-1, 8, 128))
        for n, g, w in zip(("prob", "palive", "mean", "cov", "convert", "kill", "n_over"), pair, k11):
            assert torch.equal(g.reshape(w.shape), w), (t, n)
        assert torch.equal(found, k11[7])


# ---------------------------------------------------------------------- K13


def _k13_built(case, rng):
    """One lane, one slot: a random map and 100 particles along a ray, with
    built degenerate particles, an empty region or a planted tie."""
    maps = torch.tensor(rng.uniform(0.3, 2.0, (1, 1, H, W)), dtype=torch.float32)
    u = np.linspace(80, 160, NP)
    h = torch.tensor(np.stack([u, 100 + 0.3 * (u - 80)], -1)[None, None], dtype=torch.float32)
    sinv = torch.tensor(np.tile([[0.05, 0.01], [0.01, 0.04]], (1, 1, NP, 1, 1)), dtype=torch.float32)
    alive = torch.ones((1, 1, NP), dtype=torch.bool)
    if case == "degenerate":
        sinv[0, 0, 0] = float("nan")                                           # S^-1 of a non-SPD S
        sinv[0, 0, 1] = torch.tensor([[1e-30, 0.0], [0.0, 1e-30]])             # half-extents beyond int32
        sinv[0, 0, 2] = torch.tensor([[1.0, 2.0], [2.0, 1.0]])                 # indefinite
        sinv[0, 0, 3] = torch.tensor([[1e-6, 0.0], [0.0, 1e-6]])               # overflowing ellipse
        h[0, 0, 4] = torch.tensor([-1e12, 5.0])                                # centre far off the frame
        h[0, 0, 5] = torch.tensor([float("nan"), 50.0])
        h[0, 0, 6] = torch.tensor([3e9, 3e9])
        maps[0, 0, 95:105, 95:105] = 0.1
    elif case == "empty":
        sinv[0, 0, :] = torch.tensor([[4.0, 0.0], [0.0, 4.0]])                 # half-extent 1
        h[0, 0, :10, 0] = -40.0                                                # window clamped away
        alive[0, 0, 10:20] = False
    else:
        maps[0, 0, 102, 104] = maps[0, 0, 100, 104] = maps[0, 0, 101, 103] = 0.05   # equal minima
        h[0, 0, :] = torch.tensor([104.3, 101.2])
    return maps, h, sinv, alive


def _k13_cases(route_inputs, case):
    if case == "real":
        store = route_inputs["sb0"][0]
        ts = _frames_where(store, "particle_search", lambda a: bool(a[3].any()))
        return [store[("particle_search", t)][0][:4] for t in ts[:: max(1, len(ts) // 3)]]
    return [_k13_built(case, np.random.default_rng(13))]


@pytest.mark.parametrize("case", ["real", "degenerate", "empty", "tie"])
def test_k13_plain_matches_pallas_and_dense(case, route_inputs):
    for maps, h, sinv, alive in _k13_cases(route_inputs, case):
        got = particle_search_plain(maps, h, sinv, alive, PSC)
        kw = dict(win_radius=PSC.win_radius, no_sigma=PSC.no_sigma, corr_thresh2=PSC.corr_thresh2)
        dense = correlate.multi_ellipse_search_dense(maps, h, sinv, alive, **kw)
        Fl = maps.shape[0] * maps.shape[1]
        flat = [t.reshape(Fl, *t.shape[2:]) for t in (maps, h, sinv, alive)]
        want = pallas_multi_ellipse_search(*(j(t) for t in flat), interpret=True, **kw)
        want_dense = jax.vmap(lambda m, hh, s, a: jcorr.multi_ellipse_search_dense(m, hh, s, a, **kw))(
            *(j(t) for t in flat))
        for n, g, w, gd, wd in zip(("found", "u", "v", "over"), got, want, dense, want_dense):
            np.testing.assert_array_equal(g.reshape(Fl, -1).numpy(), np.asarray(w), err_msg=f"K13 {n}")
            np.testing.assert_array_equal(gd.reshape(Fl, -1).numpy(), np.asarray(wd), err_msg=f"dense {n}")
            if case != "degenerate":      # half-extents in int32: the two searches agree
                keep = got[0] if n in ("u", "v") else torch.ones_like(got[0])     # dead: no key in K13
                np.testing.assert_array_equal(g[keep].numpy(), gd[keep].numpy(), err_msg=f"K13 vs dense {n}")
        if case == "tie":
            assert bool(got[0][0, 0, 0]) and (int(got[1][0, 0, 0]), int(got[2][0, 0, 0])) == (104, 102)
        if case == "empty":
            assert not got[0][0, 0, :20].any()
        if case == "degenerate":
            assert bool(got[3][0, 0, 3]) and not bool(got[0][0, 0, 0])


@pytest.mark.parametrize("case", ["real", "degenerate", "empty", "tie"])
def test_k13_work_counts_read_each_slot_union_once(case, route_inputs):
    """K13's bound reads each map cell under a slot's live regions once (the
    union of the regions) and searches every live region whole."""
    for maps, h, sinv, alive in _k13_cases(route_inputs, case):
        n_read, n_searched = region_cells(h, sinv, alive, PSC)
        geo = region_geometry(h, sinv, alive, PSC)[0].reshape(-1, alive.shape[-1], 7).tolist()
        want_read = want_searched = 0
        for slot in geo:
            cover = torch.zeros((H, W), dtype=torch.bool)
            for _uc, _vc, v_lo, v_hi, u_lo, u_hi, live in slot:
                if live and v_hi > v_lo and u_hi > u_lo:
                    cover[v_lo:v_hi, u_lo:u_hi] = True
                    want_searched += (v_hi - v_lo) * (u_hi - u_lo)
            want_read += int(cover.sum())
        assert (n_read, n_searched) == (want_read, want_searched)
        assert n_read <= maps.numel()
        if case == "tie":        # 100 particles on one centre: one region, read once
            assert n_searched == NP * n_read


# ------------------------------------------------------ correlate, Shi-Tomasi


def test_score_maps_match_jax_fast_mode(route_inputs):
    store, _outs, frames = route_inputs["bp0"]
    patches = store[("search_windows", 12)][0][1][:, :1]          # a selected feature's patch, [B, 1, b, b]
    fr = torch.as_tensor(frames[12])
    sg1, sg1sq, valid = correlate.frame_sums(fr, B)
    cross = correlate.cross_sum_maps(fr, patches, B)
    sg0, sg0sq = correlate.patch_stats(patches)
    maps = correlate.score_maps(fr, patches, B, P_STD.corr_sigma_thresh, P_STD.low_sigma_penalty)
    with jax.enable_x64(False):
        for b in range(len(LANES)):
            fs = jcorr.frame_sums(j(fr[b]), B)
            np.testing.assert_array_equal(sg1[b].numpy(), np.asarray(fs.sg1))
            np.testing.assert_array_equal(sg1sq[b].numpy(), np.asarray(fs.sg1sq))
            np.testing.assert_array_equal(valid.numpy(), np.asarray(fs.valid))
            jc = jcorr.cross_sum_maps(j(fr[b]), j(patches[b]), B)
            np.testing.assert_array_equal(cross[b].numpy(), np.asarray(jc))
            s0, s0sq = jcorr.patch_stats(j(patches[b]))
            np.testing.assert_array_equal(sg0[b].numpy(), np.asarray(s0))
            np.testing.assert_array_equal(sg0sq[b].numpy(), np.asarray(s0sq))
            want = np.asarray(jcorr.penalized_score_map(fs, jc[0], s0[0], s0sq[0], B,
                                                        P_STD.corr_sigma_thresh, P_STD.low_sigma_penalty))
            got = maps[b, 0].numpy()
            assert want.dtype == np.float32
            np.testing.assert_array_equal(got == 1e6, want == 1e6)
            np.testing.assert_allclose(got, want, rtol=MAP_RTOL, atol=MAP_ATOL)


def test_xla_shi_tomasi_matches_jax_and_k6_plain(route_inputs):
    """On the regions that the bp0 replay picks in (and shifted copies of
    them): K6's plain version over lanes, which route bp0 runs, equals JAX's
    XLA form (eigenvalue within 1e-6 relative) and itself lane by lane."""
    store, _outs, frames = route_inputs["bp0"]
    calls = [store[k] for k in sorted(store) if k[0] == "shi_tomasi_plain"]
    assert calls
    kw = calls[0][1]
    n = 0
    for (a, _k), t in zip(calls[::4], range(0, N_STEPS, 4)):
        fr, ru, rv, ruf, rvf = a
        for du in (0, 37):
            bounds = (ru + du, rv, torch.minimum(ruf + du, torch.tensor(W - 7)), rvf)
            got = shi_tomasi_plain(fr, *bounds, **kw)
            for b in range(len(LANES)):
                k6 = shi_tomasi_plain(fr[b], *(x[b] for x in bounds), **kw)
                for g, w in zip(got, k6):
                    assert torch.equal(g[b], w)
                with jax.enable_x64(False):
                    want = jst.find_best_patch_in_image_window(
                        j(fr[b]), B, *(j(x[b]) for x in bounds), region_w=kw["region_w"],
                        region_h=kw["region_h"])
                assert (int(got[0][b]), int(got[1][b])) == (int(want[0]), int(want[1]))
                np.testing.assert_allclose(float(got[2][b]), float(want[2]), rtol=EV_RTOL)
                n += 1
    assert n >= 8
