"""The f64 forms of the port's step functions against the JAX package's, in
process with x64 on (the JAX package's default), on seeded inputs. Each
case states its tolerance: where the operations and their order match, the
results differ by no more than XLA's fused multiply-adds and reordered dot
products move them, a few ulps, and the bar is 1e-12 of each field's
largest entry or tighter; integer results and decisions are exact.

  motion.func_fv, the ten-step rollforward     1e-14 (13 adds / products a step)
  ekf.joint_update in f64 (unrolled, never     1e-11 of |P| (the sums of
    K14, also with pallas_chol=True)           H P H' and W S W' reorder)
  shi_tomasi_plain(dtype=f64) against          u, v exact; ev 1e-12 relative
    find_best_patch_in_image_window on
    ordinary, flat and clamped regions
  correlate.score_maps / nssd_score in f64     1e-12; 1e6 cells exact
  elliptical_search_batch in f64               found, u, v, overflow exact;
                                               best 1e-12
  multi_ellipse_search_dense in f64 against    found, overflow exact, u, v
    multi_ellipse_search_unionbox on every     exact for the alive particles
    rung and on the dense fallback
  runtime.step.slot_predict against JAX's      1e-12 of each field's largest
    per-slot chain (step.py:1029-1049)         entry
  bayes_update_xla against JAX's XLA Bayes     1e-12; masks exact
    chain (step.py:1229-1279)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.config import Params as JParams
from scenelib2_tpu.core import camera as jcam
from scenelib2_tpu.core import ekf as jekf
from scenelib2_tpu.core import models as jmodels
from scenelib2_tpu.core import motion as jmotion
from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_tpu.kernels import shi_tomasi as jst
from scenelib2_torch.config import Params
from scenelib2_torch.core import camera as tcam
from scenelib2_torch.core import ekf, motion
from scenelib2_torch.eval.synthetic import make_texture, quat_to_R
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.bayes import BayesConsts, bayes_update_xla
from scenelib2_torch.kernels.search import search_window_origin
from scenelib2_torch.kernels.shi_tomasi import clamp_region, shi_tomasi_plain
from scenelib2_torch.runtime.step import slot_predict
from tests.test_torch_xla_correlate import RUNG_CASES, SEARCH_CASES, _cloud, _search_case, _union_rungs

F64 = torch.float64
P = Params()
H, W, B = P.cam_height, P.cam_width, P.boxsize
R = P.search_win_radius
SEARCH_KW = dict(win_radius=R, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2,
                 corr_sigma_thresh=P.corr_sigma_thresh)
PARTICLE_KW = dict(win_radius=P.particle_win_radius, no_sigma=P.no_sigma, corr_thresh2=P.corr_thresh2)
JCAM = jcam.CameraParams.from_params(JParams())
TCAM = tcam.CameraParams.from_params(P)


@pytest.fixture(autouse=True)
def _x64():
    with jax.enable_x64(True):
        yield


def j(a):
    return jnp.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)


def t(a):
    return torch.as_tensor(np.asarray(a))


def close(got, want, tol, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float64, what
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def frame():
    tex = make_texture(np.random.default_rng(5), size=512)
    return tex[100 : 100 + H, 50 : 50 + W].round().astype(np.uint8)


def _xv(rng):
    q = rng.normal(size=4)
    return np.concatenate([rng.normal(size=3), q / np.linalg.norm(q), rng.normal(scale=0.3, size=3),
                           rng.normal(scale=0.5, size=3)])


# ---------------------------------------------------------------- motion


@pytest.mark.parametrize("seed", range(4))
def test_func_fv_and_the_ten_step_rollforward_match_jax(seed):
    rng = np.random.default_rng(seed)
    xv = _xv(rng)
    u = np.zeros(3)
    dt = P.delta_t
    close(motion.func_fv(t(xv), t(u), dt).numpy(), jmotion.func_fv(j(xv), j(u), dt), 1e-14, "func_fv")
    tx, jx = t(xv), j(xv)
    for _ in range(P.init_steps_to_predict):
        tx, jx = motion.func_fv(tx, t(u), dt), jmotion.func_fv(jx, j(u), dt)
    close(tx.numpy(), jx, 1e-14, "rollforward")
    # the lane form over a leading dimension and the position-state helpers
    xs = np.stack([_xv(rng) for _ in range(3)])
    lanes = motion.func_fv(t(xs), t(u), dt).numpy()
    for b in range(3):
        close(lanes[b], jmotion.func_fv(j(xs[b]), j(u), dt), 1e-14, "func_fv lanes")
    np.testing.assert_array_equal(motion.func_xp(t(xv)).numpy(), np.asarray(jmotion.func_xp(j(xv))))
    np.testing.assert_array_equal(motion.dxp_by_dxv().numpy(), np.asarray(jmotion.dxp_by_dxv()))
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in
               zip(motion.extract_r_q_v_omega(t(xv)), jmotion.extract_r_q_v_omega(j(xv))))


# ---------------------------------------------------------------- EKF update


@pytest.mark.parametrize("seed", range(3))
def test_joint_update_in_f64_factors_unrolled_as_jax(seed, monkeypatch):
    rng = np.random.default_rng(seed + 10)
    D, M = 13 + 6 * 3, 6
    A = rng.normal(size=(D, D))
    Pm = A @ A.T / D + np.eye(D) * 0.1
    x = rng.normal(size=D)
    Hm = rng.normal(size=(M, D))
    Hm[2:4] = 0.0                                         # a failed measurement: H = 0, nu = 0, R = I
    nu = rng.normal(size=M)
    nu[2:4] = 0.0
    Rm = np.diag(rng.uniform(0.5, 2.0, M))
    Rm[2:4, 2:4] = np.eye(2)
    monkeypatch.setattr(ekf, "chol_inv", lambda S: pytest.fail("K14 is f32-only"))
    for pallas_chol in (True, False):
        got = ekf.joint_update(t(x), t(Pm), t(Hm), t(nu), t(Rm), pallas_chol=pallas_chol)
        want = jekf.joint_update(j(x), j(Pm), j(Hm), j(nu), j(Rm), pallas_chol=pallas_chol)
        for name, g, w in zip(("x", "P", "S"), got, want):
            close(g.numpy(), w, 1e-11, f"{name} (pallas_chol={pallas_chol})")


# ---------------------------------------------------------------- Shi-Tomasi


def _st_bounds(case, rng):
    RW, RH = P.init_search_width, P.init_search_height
    if case == "clamped":
        us, vs = (-7, 150)[rng.integers(2)], (-3, 170)[rng.integers(2)]
    else:
        us, vs = int(rng.integers(10, W - RW - 10)), int(rng.integers(10, H - RH - 10))
    return us, vs, us + RW, vs + RH


@pytest.mark.parametrize("case", ["ordinary", "flat", "clamped"])
def test_shi_tomasi_f64_picks_as_jax_find_best_patch(case, frame):
    rng = np.random.default_rng(["ordinary", "flat", "clamped"].index(case))
    RW, RH = P.init_search_width, P.init_search_height
    for _ in range(4):
        fr = frame.copy()
        us, vs, uf, vf = _st_bounds(case, rng)
        if case == "flat":
            fr[max(vs - 8, 0) : vf + 8, max(us - 8, 0) : uf + 8] = 77
        b = clamp_region(*(torch.tensor(v, dtype=torch.int32) for v in (us, vs, uf, vf)), W, H, B)
        ub, vb, ev = shi_tomasi_plain(t(fr), *b, boxsize=B, region_w=RW, region_h=RH, dtype=F64)
        jb = jst.clamp_region(*(jnp.int32(v) for v in (us, vs, uf, vf)), W, H, B)
        wu, wv, wev = jst.find_best_patch_in_image_window(j(fr), B, *jb, region_w=RW, region_h=RH)
        assert (int(ub), int(vb)) == (int(wu), int(wv)), case
        assert ev.dtype == F64 and np.asarray(wev).dtype == np.float64
        np.testing.assert_allclose(float(ev), float(wev), rtol=1e-12, atol=0, err_msg=case)
        if case == "flat":
            assert float(ev) == 0.0 and (int(ub), int(vb)) == (int(b[0]), int(b[1]))
        else:
            assert float(ev) > 0.0


# ---------------------------------------------------------------- NSSD search and score maps


def test_score_maps_f64_match_jax_penalized_maps(frame):
    rng = np.random.default_rng(3)
    fr = frame.copy()
    fr[100:140, 200:260] = 90                            # a flat image region (deviation 0)
    fr[20:60, 20:60] //= 16                              # low image deviation
    pts = [(60, 80), (250, 200), (150, 120)]
    patches = np.stack([fr[v - 5 : v + 6, u - 5 : u + 6] for u, v in pts])
    patches[2] = 128                                     # a flat patch
    got = correlate.score_maps(t(fr)[None], t(patches)[None], B, P.corr_sigma_thresh,
                               P.low_sigma_penalty, dtype=F64)[0]
    assert got.dtype == F64
    fs = jcorr.frame_sums(j(fr), B)
    cross = jcorr.cross_sum_maps(j(fr), j(patches), B)
    sg0, sg0sq = jcorr.patch_stats(j(patches))
    for k in range(len(pts)):
        want = np.asarray(jcorr.penalized_score_map(fs, cross[k], sg0[k], sg0sq[k], B,
                                                    P.corr_sigma_thresh, P.low_sigma_penalty))
        assert want.dtype == np.float64
        np.testing.assert_array_equal(got[k].numpy() == 1e6, want == 1e6)
        close(got[k].numpy(), want, 1e-12, f"score map {k}")
    # the flat patch against the flat region: both deviations 0, the special 0
    assert float(got[2, 120, 230]) == 0.0 + P.low_sigma_penalty
    corr, sd0, sd1 = correlate.nssd_score(*(t(np.float64(v)) for v in (1000.0, 9000.0, 1100.0, 12000.0,
                                                                          10000.0)), 121.0)
    wc, ws0, ws1 = jcorr.nssd_score(*(jnp.float64(v) for v in (1000.0, 9000.0, 1100.0, 12000.0, 10000.0)),
                                    121.0)
    for g, w in ((corr, wc), (sd0, ws0), (sd1, ws1)):
        assert g.dtype == F64
        close(g.numpy(), w, 1e-14, "nssd_score")


@pytest.mark.parametrize("case", SEARCH_CASES)
def test_elliptical_search_batch_f64_decides_as_jax(case, frame):
    fr, patches, h, sinv, active = _search_case(case, frame)
    rng = np.random.default_rng(SEARCH_CASES.index(case))
    h = h.astype(np.float64) + rng.uniform(-1e-3, 1e-3, h.shape)
    sinv = sinv.astype(np.float64) * (1.0 + rng.uniform(-1e-6, 1e-6, (len(h), 1, 1)))
    sinv[:, 1, 0] = sinv[:, 0, 1]
    frt, pt, ht = t(fr)[None], t(patches)[None], t(h)[None]
    u0, v0, _uc, _vc = search_window_origin(ht, R, W, H, B)
    sg1, sg1sq, _valid = correlate.frame_sums(frt, B, F64)
    cross = correlate.cross_sum_windows(frt, pt, u0, v0, R, B)
    sg0, sg0sq = correlate.patch_stats(pt, F64)
    abc = t(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], -1))[None]
    found, u, v, best, over = (r[0] for r in correlate.elliptical_search_batch(
        sg1, sg1sq, cross, sg0, sg0sq, u0, v0, ht, abc, t(active)[None], B, **SEARCH_KW))
    fs = jcorr.frame_sums(j(fr), B)
    jsg0, jsg0sq = jcorr.patch_stats(j(patches))
    want = jcorr.elliptical_search_batch(fs, j(cross[0]), jsg0, jsg0sq, j(u0[0]), j(v0[0]), j(h), j(sinv),
                                         j(active), B, **SEARCH_KW)
    for name, g, w in (("found", found, want.found), ("u", u, want.u), ("v", v, want.v),
                       ("overflow", over, want.overflow)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{case}: {name}")
    np.testing.assert_array_equal(best.numpy() == 1e6, np.asarray(want.best) == 1e6)
    close(best.numpy(), want.best, 1e-12, f"{case}: best")
    if case in ("borders", "random"):
        assert int(found.sum()) >= 6


def _rung_taken_f64(h, sinv, alive):
    """The rung of multi_ellipse_search_unionbox's ladder that these
    particles take in f64 (len(rungs): the dense fallback)."""
    rad, ns = PARTICLE_KW["win_radius"], PARTICLE_KW["no_sigma"]
    side_u, side_v = min(2 * rad + 1, W), min(2 * rad + 1, H)
    uc, vc = np.trunc(h[:, 0]).astype(np.int64), np.trunc(h[:, 1]).astype(np.int64)
    a, b, c = sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]
    hw = np.floor(ns / np.sqrt(a - b * b / c)).astype(np.int64)
    hh = np.floor(ns / np.sqrt(c - b * b / a)).astype(np.int64)
    u0, v0 = np.clip(uc - rad, 0, W - side_u), np.clip(vc - rad, 0, H - side_v)
    v_lo, v_hi = np.maximum(v0, vc - hh), np.minimum(v0 + side_v, vc + hh + 1)
    u_lo, u_hi = np.maximum(u0, uc - hw), np.minimum(u0 + side_u, uc + hw + 1)
    ne = alive & (v_lo < v_hi) & (u_lo < u_hi)
    dv, du = v_hi[ne].max() - v_lo[ne].min(), u_hi[ne].max() - u_lo[ne].min()
    rungs = _union_rungs()
    return next((k for k, (bh, bw) in enumerate(rungs) if dv <= bh and du <= bw), len(rungs))


@pytest.mark.parametrize("case", list(RUNG_CASES))
def test_dense_particle_search_f64_equals_jax_unionbox_on_every_rung(case):
    cmap, h, sinv, alive = _cloud(case)
    rng = np.random.default_rng(list(RUNG_CASES).index(case) + 5)
    cmap = np.where(cmap < 1e6, cmap.astype(np.float64) + rng.uniform(0, 1e-9, cmap.shape), 1e6)
    h = h.astype(np.float64) + rng.uniform(-1e-4, 1e-4, h.shape)
    sinv = sinv.astype(np.float64) * (1.0 + rng.uniform(-1e-7, 1e-7, (len(h), 1, 1)))
    sinv[:, 1, 0] = sinv[:, 0, 1]
    mid = len(h) // 2                    # keep the planted tie of _cloud a tie in f64
    cmap[int(h[mid, 1]) + 1, int(h[mid, 0]) - 1] = cmap[int(h[mid, 1]), int(h[mid, 0])] = 0.01
    assert _rung_taken_f64(h, sinv, alive) == min(RUNG_CASES[case][2], len(_union_rungs()))
    got = correlate.multi_ellipse_search_dense(*(t(a)[None, None] for a in (cmap, h, sinv, alive)),
                                               **PARTICLE_KW)
    got = [g[0, 0].numpy() for g in got]
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
    assert got[0][mid] and (int(got[1][mid]), int(got[2][mid])) == (int(h[mid, 0]), int(h[mid, 1]))


# ---------------------------------------------------------------- stage 8 chain


def _slot_inputs(rng, Bn=2, F=1, NP=20):
    xs = np.stack([_xv(rng) for _ in range(Bn)])
    xp = xs[:, None, :7]
    A = rng.normal(size=(Bn, 1, 13, 13))
    C = A @ A.transpose(0, 1, 3, 2) * 1e-3
    Pxx7 = C[..., :7, :7]
    pxy6 = C[..., :13, 7:13].repeat(F, 1)
    pyy6 = C[..., 7:13, 7:13].repeat(F, 1) + np.eye(6) * 1e-3
    # rays in front of the camera: origin near the camera, direction its optical axis
    ys6 = np.concatenate([xs[:, None, :3] + rng.normal(scale=0.05, size=(Bn, F, 3)),
                          np.tile([0.1, -0.1, 1.0], (Bn, F, 1)) + rng.normal(scale=0.05, size=(Bn, F, 3))], -1)
    for b in range(Bn):                                  # the direction in the world frame
        ys6[b, :, 3:6] = ys6[b, :, 3:6] @ quat_to_R(xs[b, 3:7]).T
    lam = np.sort(rng.uniform(0.5, 5.0, (Bn, F, NP)), -1)
    return xp, Pxx7, ys6, pxy6, pyy6, lam


def _jax_slot_chain(xp, Pxx7, ys6, pxy6, pyy6, lam):
    """scenelib2_tpu/runtime/step.py:1029-1049, the f64 per-slot chain, for one lane."""
    def per_slot(y6, pxy_i, pyy_i, lam_row):
        zeroed, dz_by_dxp, dz_by_dyi = jmodels.part_zeroedyi(y6, xp)
        pxy7 = pxy_i[:7]

        def per_particle(lam_p):
            hpi, hx7, hy6 = jmodels.part_predict_from_zeroed(JCAM, zeroed, dz_by_dxp, dz_by_dyi, lam_p)
            Rn = jcam.measurement_noise(JCAM, hpi)
            tt = hx7 @ pxy7 @ hy6.T
            S = hx7 @ Pxx7 @ hx7.T + tt + tt.T + hy6 @ pyy_i @ hy6.T + Rn
            return hpi, jekf.inv2x2_via_chol(S), S[0, 0] * S[1, 1] - S[1, 0] * S[0, 1]

        return jax.vmap(per_particle)(lam_row)

    return jax.vmap(per_slot)(ys6, pxy6, pyy6, lam)


@pytest.mark.parametrize("seed", range(3))
def test_slot_predict_matches_the_jax_per_slot_chain(seed):
    rng = np.random.default_rng(seed + 40)
    xp, Pxx7, ys6, pxy6, pyy6, lam = _slot_inputs(rng)
    got = slot_predict(TCAM, *(t(a) for a in (xp, Pxx7, ys6, pxy6, pyy6, lam)))
    for b in range(xp.shape[0]):
        want = _jax_slot_chain(j(xp[b, 0]), j(Pxx7[b, 0]), j(ys6[b]), j(pxy6[b]), j(pyy6[b]), j(lam[b]))
        for name, g, w in zip(("hpi", "sinv", "dets"), got, want):
            assert np.isfinite(np.asarray(w)).all(), name
            close(g[b].numpy(), w, 1e-12, f"lane {b}: {name}")


def _jax_bayes(prob_c, lam_c, palive_c, found, p_over, z, hpi, sinv, dets, making, pmask, ma, p):
    """scenelib2_tpu/runtime/step.py:1229-1279, the f64 XLA Bayes chain."""
    n_p_overflow = jnp.sum(p_over).astype(jnp.int32)
    nu = z - hpi
    quad = jnp.einsum("fpi,fpij,fpj->fp", nu, sinv, nu)
    gauss = (1.0 / jnp.sqrt(2.0 * jnp.pi * dets)) * jnp.exp(-0.5 * quad)
    likelihood = jnp.where(found, gauss, jnp.where(p_over, 1.0, 0.0))
    upd = making[:, None] & palive_c
    prob = jnp.where(upd, prob_c * likelihood, prob_c)
    total = jnp.sum(jnp.where(palive_c, prob, 0.0), axis=1)
    all_zero = making & (total == 0.0)
    safe_total = jnp.where(total > 0.0, total, 1.0)
    prob_n = jnp.where(making[:, None], prob / safe_total[:, None], prob)
    n_alive = jnp.sum(palive_c, axis=1)
    thresh = p.prune_prob_thresh / jnp.maximum(n_alive, 1).astype(jnp.float64)
    keep = palive_c & ~(making[:, None] & (prob_n < thresh[:, None]))
    prob_k = jnp.where(keep, prob_n, 0.0)
    total2 = jnp.sum(prob_k, axis=1)
    prob_f = jnp.where(making[:, None] & (total2[:, None] > 0.0),
                       prob_k / jnp.where(total2 > 0, total2, 1.0)[:, None], prob_k)
    palive_f = jnp.where(making[:, None], keep, palive_c)
    n_alive_f = jnp.sum(palive_f, axis=1)
    mean = jnp.sum(lam_c * prob_f, axis=1)
    exp2 = jnp.sum(lam_c * lam_c * prob_f, axis=1)
    cov = exp2 - mean * mean
    ratio = jnp.sqrt(cov) / mean
    convert = making & ~all_zero & (ratio < p.sd_depth_ratio) & (n_alive_f > p.min_particles)
    sell_by = pmask & ~convert & ((ma > p.erase_partial_after_attempts) | (n_alive_f <= p.min_particles))
    return prob_f, palive_f, mean, cov, convert, all_zero | sell_by, n_p_overflow


@pytest.mark.parametrize("seed", range(3))
def test_bayes_update_xla_f64_matches_the_jax_chain(seed):
    rng = np.random.default_rng(seed + 60)
    F, NP = 4, 100
    lam = np.sort(rng.uniform(0.5, 5.0, (F, NP)), -1)
    prob = rng.uniform(0.0, 1.0, (F, NP))
    prob /= prob.sum(-1, keepdims=True)
    palive = rng.uniform(size=(F, NP)) > 0.2
    hpi = rng.uniform(50, 250, (F, NP, 2))
    # a converging cloud in slot 0: the matches cluster around depth 2
    found = rng.uniform(size=(F, NP)) > 0.3
    found[0] = np.abs(lam[0] - 2.0) < 0.3
    found[2] = False                                     # all zero: slot 2 dies
    p_over = ~found & (rng.uniform(size=(F, NP)) > 0.9)
    p_over[2] = False
    z = hpi + rng.normal(scale=1.0, size=(F, NP, 2))
    su = rng.uniform(1.0, 3.0, (F, NP))
    S = np.zeros((F, NP, 2, 2))
    S[..., 0, 0], S[..., 1, 1], S[..., 0, 1] = su * su, su * su * 1.2, 0.3 * su
    S[..., 1, 0] = S[..., 0, 1]
    sinv = np.linalg.inv(S)
    dets = np.linalg.det(S)
    making = np.array([True, True, True, False])
    pmask = np.array([True, True, True, True])
    ma = np.array([3, 12, 4, 2], np.int32)
    bc = BayesConsts.from_params(P)
    args = (prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask, ma)
    got = bayes_update_xla(*(t(a) for a in args), bc)
    want = _jax_bayes(*(j(a) for a in args), JParams())
    # JAX sums the overflow counts over the slots, the port per slot
    got = (*got[:6], got[6].sum().to(torch.int32))
    for name, g, w in zip(("prob", "palive", "mean", "cov", "convert", "kill", "n_over"), got, want):
        w = np.asarray(w)
        if w.dtype == np.float64:
            close(g.numpy(), w, 1e-12, name)
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert bool(got[5][2]) and not bool(got[5][3])
