"""The pure-XLA route's image functions (scenelib2_torch/kernels/correlate.py)
against the JAX package's, in its fast mode (f32: jax.enable_x64(False)),
on seeded frames and built cases.

  cross_sum_windows         both JAX gather forms (dynamic_slice and
                            index_gather) exactly, on windows clipped at
                            every border: one gather stands for both
  elliptical_search_batch   found, u, v and overflow exactly, best within
                            2e-5 absolute (K2's bar: XLA may contract the
                            NSSD formula's products into fused multiply-adds
                            on the CPU), on windows clipped at every border,
                            planted ties, flat patches and flat image
                            regions, and overflowing ellipses
  the particle search       the port's multi_ellipse_search_dense, which the
                            single stream's XLA route runs in place of
                            correlate.multi_ellipse_search_unionbox: found
                            and overflow exactly for every particle, u and v
                            exactly for the alive ones (the union box holds
                            only theirs), on clouds whose union box takes
                            rung 0 (16 x 128), rung 1 (48 x 192), the cap
                            rung (side + 63 x side + 127) and the dense
                            fallback; and exactly JAX's dense form
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_torch.config import Params
from scenelib2_torch.eval.synthetic import make_texture
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.search import search_window_origin

P = Params()
H, W, B = P.cam_height, P.cam_width, P.boxsize
HALF = (B - 1) // 2
R = P.search_win_radius
BEST_ATOL = 2e-5
SEARCH_KW = dict(win_radius=R, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2,
                 corr_sigma_thresh=P.corr_sigma_thresh)
PARTICLE_KW = dict(win_radius=P.particle_win_radius, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2)
SEARCH_CASES = ("borders", "ties", "flat", "overflow", "random")
# the ties case: features on a grid, each patch's neighbourhood copied 11-12
# pixels away (no overlap with the original), inside a sigma-6 ellipse
TIE_PTS = ((50, 50), (120, 50), (190, 50), (260, 60), (60, 150), (150, 150))
TIE_OFFS = ((12, 0), (0, 12), (-12, 0), (0, -12), (11, 11), (-11, 11))


def j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


@pytest.fixture(scope="module")
def frame():
    tex = make_texture(np.random.default_rng(5), size=512)
    return tex[100 : 100 + H, 50 : 50 + W].round().astype(np.uint8)


def _sinv(rng, K, sigma_lo=1.0, sigma_hi=6.0):
    """S^-1 of K random SPD 2 x 2 S (standard deviations sigma_lo..sigma_hi)."""
    su, sv = rng.uniform(sigma_lo, sigma_hi, K), rng.uniform(sigma_lo, sigma_hi, K)
    rho = rng.uniform(-0.6, 0.6, K)
    S = np.stack([np.stack([su * su, rho * su * sv], -1), np.stack([rho * su * sv, sv * sv], -1)], -2)
    return np.linalg.inv(S).astype(np.float32)


def _search_case(case, frame):
    """(frame [H, W] u8, patches [K, B, B] u8, h [K, 2] f32, sinv [K, 2, 2]
    f32, active [K] bool) of one built case."""
    rng = np.random.default_rng(SEARCH_CASES.index(case) + 31)
    fr = frame.copy()
    if case == "borders":
        # centres on and past every border and corner: every window clipped
        pts = [(0, 0), (HALF, 60), (W - 1, 100), (W - HALF - 1, H - 1), (160, 0), (160, H - 1),
               (3, H - 4), (W - 3, 4), (40, 25), (W - 40, H - 25), (-20, 50), (W + 15, 130)]
    elif case == "ties":
        pts = list(TIE_PTS) + [(rng.uniform(30, W - 30), rng.uniform(90, 110)) for _ in range(3)]
    else:
        pts = [(rng.uniform(30, W - 30), rng.uniform(30, H - 30)) for _ in range(10)]
    pts = np.asarray(pts, np.float32) + rng.uniform(-0.49, 0.49, (len(pts), 2)).astype(np.float32)
    K = len(pts)
    # each patch cut where its feature truly is, displaced a few pixels
    shift = 0 if case == "ties" else rng.integers(-3, 4, (K, 2))
    true = np.clip(np.round(pts + shift), HALF, [W - HALF - 1, H - HALF - 1]).astype(int)
    patches = np.stack([fr[v - HALF : v + HALF + 1, u - HALF : u + HALF + 1] for u, v in true])
    sinv = _sinv(rng, K)
    active = np.ones(K, bool)
    active[K - 1] = False
    if case == "ties":
        # two cells with equal sums: the later one in scan order must win
        for k, ((u, v), (du, dv)) in enumerate(zip(true, TIE_OFFS)):
            fr[v + dv - HALF : v + dv + HALF + 1, u + du - HALF : u + du + HALF + 1] = patches[k]
        sinv[:6] = np.linalg.inv(np.diag([36.0, 36.0])).astype(np.float32)
    elif case == "flat":
        patches[0] = 128                                         # patch deviation 0
        patches[1] = patches[1] // 64 + 100                      # a low-deviation patch
        u, v = true[2]
        fr[v - 30 : v + 31, u - 30 : u + 31] = 90                # a flat image region
        patches[3] = fr[true[3][1] - HALF : true[3][1] + HALF + 1, true[3][0] - HALF : true[3][0] + HALF + 1]
        fr[true[4][1] - 15 : true[4][1] + 16, true[4][0] - 15 : true[4][0] + 16] //= 16   # low image sigma
    elif case == "overflow":
        sinv[:4] = np.linalg.inv(np.diag([60.0 ** 2, 9.0, ])).astype(np.float32)        # 3 sigma > R in u
        sinv[4:7] = np.linalg.inv(np.diag([4.0, 40.0 ** 2])).astype(np.float32)         # in v
        sinv[7] = np.linalg.inv(np.diag([1e6, 1e6])).astype(np.float32)                 # both, huge
    return fr, patches.astype(np.uint8), pts, sinv, active


def _port_search(fr, patches, h, sinv, active):
    frt = torch.as_tensor(fr)[None]
    pt = torch.as_tensor(patches)[None]
    ht = torch.as_tensor(h)[None]
    u0, v0, _uc, _vc = search_window_origin(ht, R, W, H, B)
    sg1, sg1sq, _valid = correlate.frame_sums(frt, B)
    cross = correlate.cross_sum_windows(frt, pt, u0, v0, R, B)
    sg0, sg0sq = correlate.patch_stats(pt)
    abc = torch.as_tensor(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], -1))[None]
    res = correlate.elliptical_search_batch(sg1, sg1sq, cross, sg0, sg0sq, u0, v0, ht, abc,
                                            torch.as_tensor(active)[None], B, **SEARCH_KW)
    return u0[0], v0[0], cross[0], [t[0] for t in res]


@pytest.mark.parametrize("case", ["borders", "random"])
def test_cross_sum_windows_equals_both_jax_gathers(case, frame):
    fr, patches, h, _sinv_, _active = _search_case(case, frame)
    u0, v0, cross, _res = _port_search(fr, patches, h, _sinv_, _active)
    with jax.enable_x64(False):
        ju0, jv0, _, _ = jcorr.search_window_origin(j(h), R, W, H, B, round_half=True)
        np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
        np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
        for index_gather in (False, True):
            want = jcorr.cross_sum_windows(j(fr), j(patches), ju0, jv0, R, B, index_gather=index_gather)
            assert want.dtype == jnp.int32
            np.testing.assert_array_equal(cross.numpy(), np.asarray(want), err_msg=f"index_gather={index_gather}")
    if case == "borders":      # the clipped windows reach every edge of the frame
        side = cross.shape[-1]
        assert int(u0.min()) == HALF and int(u0.max()) == W - side - HALF
        assert int(v0.min()) == HALF and int(v0.max()) == H - cross.shape[-2] - HALF


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_elliptical_search_batch_decides_as_jax(case, frame):
    fr, patches, h, sinv, active = _search_case(case, frame)
    u0, v0, cross, (found, u, v, best, over) = _port_search(fr, patches, h, sinv, active)
    with jax.enable_x64(False):
        fs = jcorr.frame_sums(j(fr), B)
        sg0, sg0sq = jcorr.patch_stats(j(patches))
        for index_gather in (False, True):
            want = jcorr.elliptical_search_batch(fs, j(cross), sg0, sg0sq, j(u0), j(v0), j(h), j(sinv), j(active),
                                                 B, index_gather=index_gather, **SEARCH_KW)
            for name, g, w in (("found", found, want.found), ("u", u, want.u), ("v", v, want.v),
                               ("overflow", over, want.overflow)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{case}: {name}")
            assert np.asarray(want.best).dtype == np.float32
            np.testing.assert_array_equal(best.numpy() == 1e6, np.asarray(want.best) == 1e6)
            np.testing.assert_allclose(best.numpy(), np.asarray(want.best), rtol=0, atol=BEST_ATOL)
    assert not found[-1] and not over[-1]                         # the inactive feature
    if case in ("borders", "random"):
        assert int(found.sum()) >= 6
    elif case == "ties":
        assert found[:6].all()
        for k, ((pu, pv), (du, dv)) in enumerate(zip(TIE_PTS, TIE_OFFS)):
            later = (du, dv) if du * H + dv > 0 else (0, 0)      # the larger u * H + v wins
            assert (int(u[k]), int(v[k])) == (pu + later[0], pv + later[1]), k
    elif case == "flat":
        assert not found[0] and float(best[0]) == 1e6            # no candidate: patch sigma 0
        assert not found[2] and float(best[2]) == 1e6            # no candidate: flat image
    elif case == "overflow":
        assert over[:8].all() and not over[8:].any()


# ---------------------------------------------------------------- particles


def _union_rungs():
    side_u, side_v = min(2 * PARTICLE_KW["win_radius"] + 1, W), min(2 * PARTICLE_KW["win_radius"] + 1, H)
    bh, bw = min(side_v + 63, H), min(side_u + 127, W)
    rungs = []
    for bh_i, bw_i in ((16, 128), (48, 192), (bh, bw)):
        bh_i, bw_i = min(bh_i, H), min(bw_i, W)
        if (bh_i, bw_i) not in rungs and (bh_i < H or bw_i < W):
            rungs.append((bh_i, bw_i))
    return rungs


def _rung_taken(h, sinv, alive):
    """The rung of multi_ellipse_search_unionbox's ladder these particles
    take (len(rungs): the dense fallback), recomputed as the JAX function
    sizes its union box."""
    rad, ns = PARTICLE_KW["win_radius"], PARTICLE_KW["no_sigma"]
    side_u, side_v = min(2 * rad + 1, W), min(2 * rad + 1, H)
    uc, vc = np.trunc(h[:, 0]).astype(np.int64), np.trunc(h[:, 1]).astype(np.int64)
    a, b, c = (sinv[:, 0, 0].astype(np.float32), sinv[:, 0, 1].astype(np.float32),
               sinv[:, 1, 1].astype(np.float32))
    hw = np.floor(np.float32(ns) / np.sqrt(a - b * b / c)).astype(np.int64)
    hh = np.floor(np.float32(ns) / np.sqrt(c - b * b / a)).astype(np.int64)
    u0, v0 = np.clip(uc - rad, 0, W - side_u), np.clip(vc - rad, 0, H - side_v)
    v_lo, v_hi = np.maximum(v0, vc - hh), np.minimum(v0 + side_v, vc + hh + 1)
    u_lo, u_hi = np.maximum(u0, uc - hw), np.minimum(u0 + side_u, uc + hw + 1)
    ne = alive & (v_lo < v_hi) & (u_lo < u_hi)
    dv = v_hi[ne].max() - v_lo[ne].min()
    du = u_hi[ne].max() - u_lo[ne].min()
    rungs = _union_rungs()
    return next((k for k, (bh, bw) in enumerate(rungs) if dv <= bh and du <= bw), len(rungs))


# case -> (rows, columns the centres span, the rung the union box takes)
RUNG_CASES = {"rung0": (4.0, 100.0, 0), "rung1": (30.0, 150.0, 1), "cap": (90.0, 150.0, 2),
              "fallback": (150.0, 250.0, 3)}


def _cloud(case):
    """A score map and 100 particles along a ray whose union box spans the
    case's rows and columns, some of them dead (far off, outside the box)."""
    dv, du, _rung = RUNG_CASES[case]
    rng = np.random.default_rng(list(RUNG_CASES).index(case) + 71)
    NPn = 100
    cmap = rng.uniform(0.3, 3.0, (H, W)).astype(np.float32)
    cmap[rng.integers(0, H, 40), rng.integers(0, W, 40)] = rng.uniform(0.0, 0.39, 40)   # matches
    cmap[:HALF], cmap[-HALF:], cmap[:, :HALF], cmap[:, -HALF:] = 1e6, 1e6, 1e6, 1e6       # invalid centres
    t = np.linspace(0.0, 1.0, NPn)
    h = np.stack([40.0 + du * t, 60.0 + dv * t], -1) + rng.uniform(-0.5, 0.5, (NPn, 2))
    sinv = _sinv(rng, NPn, 0.8, 1.2)
    alive = rng.uniform(size=NPn) > 0.15
    over_k = NPn // 2 + 10                              # mid-cloud: its wide window stays in the box
    alive[[over_k, NPn // 2]] = True
    near = np.flatnonzero(alive)[::4]                   # a match near a quarter of the live centres
    cmap[np.trunc(h[near, 1]).astype(int) + rng.integers(-1, 2, len(near)),
         np.trunc(h[near, 0]).astype(int) + rng.integers(-1, 2, len(near))] = rng.uniform(0.0, 0.39, len(near))
    h[~alive] = rng.uniform([0, 0], [W, H], (int((~alive).sum()), 2))     # dead: anywhere
    mid = NPn // 2
    cmap[int(h[mid, 1]) + 1, int(h[mid, 0]) - 1] = cmap[int(h[mid, 1]), int(h[mid, 0])] = 0.01   # a tie
    sinv[over_k] = np.linalg.inv(np.diag([40.0 ** 2, 1.0])).astype(np.float32)    # overflowing
    return cmap, h.astype(np.float32), sinv, alive


@pytest.mark.parametrize("case", list(RUNG_CASES))
def test_dense_particle_search_equals_jax_unionbox_on_every_rung(case):
    cmap, h, sinv, alive = _cloud(case)
    assert _rung_taken(h, sinv, alive) == min(RUNG_CASES[case][2], len(_union_rungs()))
    got = correlate.multi_ellipse_search_dense(*(torch.as_tensor(a)[None, None] for a in (cmap, h, sinv, alive)),
                                               **PARTICLE_KW)
    got = [g[0, 0].numpy() for g in got]
    with jax.enable_x64(False):
        ub = [np.asarray(w) for w in jcorr.multi_ellipse_search_unionbox(j(cmap), j(h), j(sinv), j(alive),
                                                                          **PARTICLE_KW)]
        dense = [np.asarray(w) for w in jcorr.multi_ellipse_search_dense(j(cmap), j(h), j(sinv), j(alive),
                                                                          **PARTICLE_KW)]
    for name, g, w, d in zip(("found", "u", "v", "overflow"), got, ub, dense):
        np.testing.assert_array_equal(g, d, err_msg=f"{case}: {name} against the dense form")
        if name in ("u", "v"):
            g, w = g[alive], w[alive]
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name} against the union box")
    assert got[0].sum() >= 5 and got[3][len(h) // 2 + 10]
    mid = len(h) // 2                    # the tie: the later cell in the u-outer scan
    assert got[0][mid] and (int(got[1][mid]), int(got[2][mid])) == (int(h[mid, 0]), int(h[mid, 1]))
