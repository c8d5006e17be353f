"""The plain versions of K1, K2 and K3 against the JAX Pallas kernels, and
of K1 and K3 against the port's core reference.

Each plain PyTorch version (what a CPU tensor runs through the kernel
wrapper) is held against the TPU kernel it ports, run in Pallas interpret
mode in this process, on the same inputs made from a seeded numpy generator
at the std shapes (D = 109, MF = 16, NSEL = 10, 320x240). Decisions must be
identical; floats agree within the stated tolerances (both sides compute in
f32, with sums in different orders).

The same plain versions run in f64 against the matrix forms of
scenelib2_torch.core (itself held to scenelib2_tpu.core in test_torch_core),
which sum in another order: there the floats agree to CORE_TOL.
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_tpu.kernels import pallas_measure as jpm
from scenelib2_tpu.kernels.pallas_ekf import pallas_joint_update_norm_compact
from scenelib2_tpu.kernels.pallas_predict_measure import pallas_predict_measure
from scenelib2_tpu.kernels.pallas_search import pallas_elliptical_search_fused
from scenelib2_torch.config import Params
from scenelib2_torch.core import camera as tcam
from scenelib2_torch.core import ekf as tekf
from scenelib2_torch.core import models as tmodels
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.kernels import _build, measure
from scenelib2_torch.kernels.ekf_update import UpdateConsts, joint_update
from scenelib2_torch.kernels.measure import MeasureConsts
from scenelib2_torch.kernels.predict_measure import predict_measure
from scenelib2_torch.kernels.search import SearchConsts, search, search_window_origin
from scenelib2_torch.runtime.state import patch_row

P_STD = Params()
MF, NSEL = P_STD.max_features, P_STD.n_features_to_select
D = 13 + 6 * MF
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize

# K1: per output row, |a - b| <= 1e-4 x the row's largest |entry|
# (x', P': of the matrix's); K2: NSSD best within 2e-5 absolute (scores are
# O(1) and a perfect match leaves only the rounding residue of a cancelling
# sum near 0); K3: x', P' within 1e-4 of the largest |entry|. Decisions
# exact everywhere.
K1_TOL = 1e-4
K2_BEST_ATOL = 2e-5
K3_TOL = 1e-4
# f64 plain version vs the f64 core reference: within 1e-9 of the largest
# |entry| of each compared quantity
CORE_TOL = 1e-9



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_layout_matches_jax():
    for name in ("O_H", "O_HX", "O_HY", "O_RD", "O_S", "O_SINV", "O_VIS", "O_ZZ", "O_SCORE", "NOUT"):
        assert getattr(measure, name) == getattr(jpm, name), name


def _rowwise_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    scale = np.where(fin, np.abs(want), 0.0).max(axis=-1, keepdims=True)
    err = np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0))
    rel = err / np.maximum(scale, 1e-30)
    assert (rel <= tol).all(), (what, float(rel.max()))


def _matrix_close(got, want, tol, what):
    """NaN where the reference has NaN; elsewhere within tol x max |entry|."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=what)
    got, want = got[~nan], want[~nan]
    scale = max(float(np.abs(want).max()), 1e-30)
    assert (np.abs(got - want) <= tol * scale).all(), (what, float(np.abs(got - want).max() / scale))


# ------------------------------------------------------------------- K1


def _k1_scene(rng, nan_lane=False):
    x = np.zeros(D)
    x[3] = 1.0
    x[4:7] = rng.normal(0, 0.02, 3)
    x[2] = -0.8
    x[7:10] = rng.normal(0, 0.1, 3)
    x[10:13] = rng.normal(0, 0.2, 3)
    for k in range(MF):
        x[13 + 6 * k : 13 + 6 * k + 3] = [rng.uniform(-0.3, 0.3), rng.uniform(-0.2, 0.2), 0.0]
    xpo = np.tile(x[:7], (MF, 1))
    xpo[:, :3] += rng.normal(0, 0.005, (MF, 3))
    A = rng.normal(size=(D, D))
    P = (A @ A.T / (4 * D) + np.eye(D)) * 1e-4
    act = rng.uniform(size=MF) > 0.15
    full = rng.uniform(size=MF) > 0.2
    if nan_lane:
        # a visible slot whose point covariance overflows S to inf - inf:
        # its score is NaN, clamped to -3e38 and ranked last while n_visible
        # counts it (finite inputs, so no other slot is touched)
        o = 13 + 6 * 3
        P[o, o], P[o + 1, o + 1] = 1e36, -1e36
        act[3] = full[3] = True
    return (x.astype(np.float32), P.astype(np.float32), xpo.astype(np.float32),
            act & full, act & ~full)


@pytest.mark.parametrize("case", ["random0", "random1", "random2", "nan_lane"])
def test_k1_plain_matches_pallas(case):
    rng = np.random.default_rng(["random0", "random1", "random2", "nan_lane"].index(case) + 11)
    x, P, xpo, af, ap = _k1_scene(rng, nan_lane=case == "nan_lane")
    p = P_STD
    want = pallas_predict_measure(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(xpo), jnp.asarray(af), jnp.asarray(ap),
        nsel=NSEL, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
        cam_static=(p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1), sd0=p.cam_sd,
        image_shape=(H, W), boundary=p.image_search_boundary,
        max_length_ratio=p.max_length_ratio, max_angle_difference=p.max_angle_difference,
        interpret=True,
    )
    got = predict_measure(
        torch.tensor(x), torch.tensor(P), torch.tensor(xpo), torch.tensor(af), torch.tensor(ap),
        nsel=NSEL, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
        consts=MeasureConsts.from_params(p),
    )
    meas, sel, xo, Po, top_idx, top_score, n_vis, pidx, pmask = (t.numpy() for t in got)
    wmeas, wsel, wx, wP, widx, wscore, wnvis, wpidx, wpmask = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(top_idx, widx)
    assert int(n_vis) == int(wnvis)
    np.testing.assert_array_equal(pidx, wpidx)
    np.testing.assert_array_equal(pmask, wpmask)
    sel_mask = (np.arange(NSEL) < n_vis) & (top_score > np.float32(-3e38))
    wsel_mask = (np.arange(NSEL) < wnvis) & (wscore > np.float32(-3e38))
    np.testing.assert_array_equal(sel_mask, wsel_mask)
    if case == "nan_lane":
        assert 3 not in top_idx[sel_mask] and np.isnan(meas[measure.O_SCORE, 3])
    # the feature block of P passes through the predict bit-unchanged
    np.testing.assert_array_equal(Po[13:, 13:], P[13:, 13:])
    np.testing.assert_array_equal(Po, Po.T)    # (NaN-equal: assert_array_equal)
    _matrix_close(xo, wx, K1_TOL, "x'")
    _matrix_close(Po, wP, K1_TOL, "P'")
    _rowwise_close(meas, wmeas, K1_TOL, "meas")
    _rowwise_close(sel, wsel, K1_TOL, "sel")


def _f64(a):
    return torch.tensor(np.asarray(a, np.float64))


@pytest.mark.parametrize("case", ["random0", "random1"])
def test_k1_plain_matches_core_reference_f64(case):
    """Predict by core.ekf.predict; per visible slot h, its Jacobians, R, S
    and S^-1 by core.models / core.camera / core.ekf, the visibility flags
    by full_visibility_test; the selection as a stable descending sort of
    trace(S) over the visible slots."""
    rng = np.random.default_rng(["random0", "random1"].index(case) + 51)
    x, P, xpo, af, ap = _k1_scene(rng)
    p = P_STD
    got = predict_measure(
        _f64(x), _f64(P), _f64(xpo), torch.tensor(af), torch.tensor(ap),
        nsel=NSEL, maxp=1, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
        consts=MeasureConsts.from_params(p),
    )
    meas, _sel, xo, Po, top_idx, _score, n_vis, _pidx, _pmask = (t.numpy() for t in got)
    wx, wP = tekf.predict(_f64(x), _f64(P), torch.zeros(3, dtype=torch.float64),
                          p.delta_t, p.sd_a, p.sd_alpha)
    _matrix_close(xo, wx.numpy(), CORE_TOL, "x'")
    _matrix_close(Po, wP.numpy(), CORE_TOL, "P'")

    cam = tcam.CameraParams.from_params(p)
    xp = wx[:7]
    score = np.full(MF, -np.inf)
    for k in np.flatnonzero(af):
        o = 13 + 6 * k
        y = wx[o : o + 3]
        h, hx, hy, zed = tmodels.full_predict_measurement(cam, y, xp)
        R = tcam.measurement_noise(cam, h)
        S = tmodels.innovation_covariance(wP[:7, :7], wP[:7, o : o + 3], wP[o : o + 3, o : o + 3],
                                          hx, hy, R)
        Sinv = tekf.inv2x2_via_chol(S)
        vis = int(tmodels.full_visibility_test(cam, xp, y, _f64(xpo[k]), h, p.image_search_boundary,
                                               p.max_length_ratio, p.max_angle_difference))
        m = meas[:, k]
        for what, lo, want in (
            ("h", measure.O_H, h), ("hx", measure.O_HX, hx.flatten()),
            ("hy", measure.O_HY, hy.flatten()), ("R", measure.O_RD, R[0, :1]),
            ("S", measure.O_S, torch.stack([S[0, 0], S[0, 1], S[1, 1]])),
            ("Sinv", measure.O_SINV, torch.stack([Sinv[0, 0], Sinv[0, 1], Sinv[1, 1]])),
            ("zed", measure.O_ZZ, zed[2:]),
        ):
            _matrix_close(m[lo : lo + len(want)], want.numpy(), CORE_TOL, f"slot {k} {what}")
        assert m[measure.O_VIS] == vis, k
        if vis == 0:
            score[k] = float(S[0, 0] + S[1, 1])
    assert int(n_vis) == int(np.isfinite(score).sum()) > 0
    want_idx = np.lexsort((np.arange(MF), -score))[:NSEL]
    np.testing.assert_array_equal(top_idx[: int(n_vis)], want_idx[: int(n_vis)])


# ------------------------------------------------------------------- K2


@pytest.fixture(scope="module")
def real_frame(tmp_path_factory):
    frames = generate_dataset(str(tmp_path_factory.mktemp("k2")), n_frames=2)[0]
    return frames[1]


def _k2_scene(rng, img):
    K = NSEL
    centres = np.stack([rng.uniform(30, W - 30, K), rng.uniform(30, H - 30, K)], 1)
    patches = []
    for k in range(K):
        u = int(np.clip(round(centres[k, 0] + rng.integers(-4, 5)), 5, W - 6))
        v = int(np.clip(round(centres[k, 1] + rng.integers(-4, 5)), 5, H - 6))
        patches.append(img[v - 5 : v + 6, u - 5 : u + 6])
    sinv = []
    for _ in range(K):
        s = rng.uniform(1.0, 40.0, 2)
        rho = rng.uniform(-0.6, 0.6)
        c = rho * math.sqrt(s[0] * s[1])
        Si = np.linalg.inv(np.array([[s[0], c], [c, s[1]]]))
        sinv.append(Si)
    active = rng.uniform(size=K) > 0.2
    return centres.astype(np.float32), np.stack(patches), np.stack(sinv).astype(np.float32), active


@pytest.mark.parametrize("case", ["random", "tie", "real_frame", "flat_patch"])
def test_k2_plain_matches_pallas(case, real_frame):
    rng = np.random.default_rng(["random", "tie", "real_frame", "flat_patch"].index(case) + 21)
    if case == "tie":
        # a periodic image: period-shifted cells score exactly the same, so
        # the minimum is tied and the last-tie (u, v) rule decides
        tile = rng.integers(0, 256, size=(B, B), dtype=np.uint8)
        img = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy()
    elif case == "real_frame":
        img = real_frame
    else:
        img = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    centres, patches, sinv, active = _k2_scene(rng, img)
    if case == "flat_patch":
        patches[0] = 99          # zero variance: never a match
        active[0] = True
    rows = np.stack([patch_row(torch.tensor(p)).numpy() for p in patches])
    p = P_STD
    ju0, jv0, _, _ = jcorr.search_window_origin(jnp.asarray(centres), p.search_win_radius, W, H, B,
                                                round_half=True)
    want = pallas_elliptical_search_fused(
        jnp.asarray(img), None, ju0, jv0, jnp.asarray(centres), jnp.asarray(sinv),
        jnp.asarray(active), image_shape=(H, W), boxsize=B, win_radius=p.search_win_radius,
        no_sigma=p.no_sigma, corr_thresh2=p.corr_thresh2, corr_sigma_thresh=p.corr_sigma_thresh,
        interpret=True, patch_rows=jnp.asarray(rows),
    )
    u0, v0, uc, vc = search_window_origin(torch.tensor(centres), p.search_win_radius, W, H, B)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    abc = torch.tensor(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], 1))
    got = search(torch.tensor(img), torch.tensor(rows), u0, v0, uc, vc, abc, torch.tensor(active),
                 SearchConsts.from_params(p))
    found, u, v, best, over = (t.numpy() for t in got)
    wfound, wu, wv, wbest, wover = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(found, wfound)
    np.testing.assert_array_equal(over, wover)
    np.testing.assert_array_equal(u, wu)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(best, wbest, rtol=0, atol=K2_BEST_ATOL)
    if case == "tie":
        assert found[active].any()
    if case == "flat_patch":
        assert not found[0]


# ------------------------------------------------------------------- K3


def _k3_scene(rng, mode):
    A = rng.normal(size=(D, D))
    P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
    x = rng.normal(size=D) * 0.1
    x[3:7] = rng.normal(size=4)
    x[3:7] /= np.linalg.norm(x[3:7]) * (1.0 + 1e-3)
    sel = np.zeros((measure.NOUT, NSEL), np.float32)
    sel[measure.O_HX : measure.O_HX + 14] = rng.normal(size=(14, NSEL))
    sel[measure.O_HY : measure.O_HY + 6] = rng.normal(size=(6, NSEL))
    sel[measure.O_RD] = rng.uniform(1.0, 2.0, NSEL)
    h = rng.uniform(20, 200, (NSEL, 2))
    sel[measure.O_H : measure.O_H + 2] = h.T
    z = (h + rng.normal(0, 1.0, (NSEL, 2))).astype(np.float32)
    active = rng.uniform(size=MF) > 0.2
    sel_mask = rng.uniform(size=NSEL) > 0.2
    succ = sel_mask & (rng.uniform(size=NSEL) > 0.4)
    if mode == "no_success":
        succ[:] = False
    top_idx = rng.choice(MF, NSEL, replace=False).astype(np.int32)
    active[top_idx[sel_mask]] = True
    attempts = (rng.integers(0, 14, MF) * active).astype(np.int32)
    successes = (attempts * rng.uniform(0.0, 1.0, MF)).astype(np.int32)
    sched = (rng.uniform(size=MF) > 0.6) & active
    label = np.where(active, rng.permutation(MF), -1).astype(np.int32)
    if mode == "run":
        # four list-consecutive scheduled slots: offsets 0 and 2 die now,
        # 1 and 3 are skipped and stay scheduled
        order = np.argsort(np.where(active, label, 1 << 30), kind="stable")
        active[order[:4]] = True
        sched[order[:4]] = True
        sched[order[4]] = False
    return (x.astype(np.float32), P.astype(np.float32), sel, z, succ,
            (13 + 6 * top_idx).astype(np.int32), attempts, successes, sched, active, label,
            sel_mask, top_idx)


@pytest.mark.parametrize("mode", ["mixed", "no_success", "run"])
def test_k3_plain_matches_pallas(mode):
    rng = np.random.default_rng(["mixed", "no_success", "run"].index(mode) + 31)
    (x, P, sel, z, succ, offs, att, suc, sched, active, label, sel_mask, top_idx) = _k3_scene(rng, mode)
    p = P_STD
    want = pallas_joint_update_norm_compact(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(sel), jnp.asarray(z), jnp.asarray(succ),
        jnp.asarray(offs), None, meas_rows=(jpm.O_HX, jpm.O_HY, jpm.O_RD, jpm.O_H),
        interpret=True,
        bookkeeping=(jnp.asarray(att), jnp.asarray(suc), jnp.asarray(sched), jnp.asarray(active),
                     jnp.asarray(label)),
        sel_mask=jnp.asarray(sel_mask), top_idx=jnp.asarray(top_idx),
        mina=float(p.min_attempted_measurements), frac=float(p.successful_match_fraction),
    )
    got = joint_update(*(torch.tensor(a) for a in (x, P, sel, z, succ, offs, att, suc, sched,
                                                    active, label, sel_mask, top_idx)),
                       UpdateConsts.from_params(p))
    xo, Po, att2, suc2, sched2, kill = (t.numpy() for t in got)
    wx, wP, watt, wsuc, wsched, wkill = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(att2, watt)
    np.testing.assert_array_equal(suc2, wsuc)
    np.testing.assert_array_equal(sched2, wsched)
    np.testing.assert_array_equal(kill, wkill)
    np.testing.assert_array_equal(Po, Po.T)
    if mode == "no_success":
        # the prior passes through (only the killed slots are zeroed)
        keep = np.concatenate([np.ones(13, bool), np.repeat(~kill, 6)])
        np.testing.assert_array_equal(xo, np.where(keep, x, 0.0))
        np.testing.assert_array_equal(Po, np.where(keep[:, None] & keep[None, :], P, 0.0))
    if mode == "run":
        assert kill.sum() >= 2 and (sched2 & active).any()
    _matrix_close(xo, wx, K3_TOL, "x'")
    _matrix_close(Po, wP, K3_TOL, "P'")


@pytest.mark.parametrize("mode", ["mixed", "run"])
def test_k3_plain_matches_core_reference_f64(mode):
    """H, nu, R formed densely from the selected columns, then
    core.ekf.joint_update, normalise, the killed slots zeroed, symmetrize."""
    rng = np.random.default_rng(["mixed", "run"].index(mode) + 61)
    (x, P, sel, z, succ, offs, att, suc, sched, active, label, sel_mask, top_idx) = _k3_scene(rng, mode)
    got = joint_update(_f64(x), _f64(P), _f64(sel), _f64(z), *(torch.tensor(a) for a in (
        succ, offs, att, suc, sched, active, label, sel_mask, top_idx)),
        UpdateConsts.from_params(P_STD))
    xo, Po, _att, _suc, _sched, kill = (t.numpy() for t in got)
    assert succ.any()
    M = 2 * NSEL
    Hm, nu, R = np.zeros((M, D)), np.zeros(M), np.eye(M)
    sel64, z64 = sel.astype(np.float64), z.astype(np.float64)
    for k in np.flatnonzero(succ):
        for i in range(2):
            m = 2 * k + i
            Hm[m, :7] = sel64[measure.O_HX + 7 * i : measure.O_HX + 7 * i + 7, k]
            Hm[m, offs[k] : offs[k] + 3] = sel64[measure.O_HY + 3 * i : measure.O_HY + 3 * i + 3, k]
            nu[m] = z64[k, i] - sel64[measure.O_H + i, k]
            R[m, m] = sel64[measure.O_RD, k]
    xu, Pu, _ = tekf.joint_update(_f64(x), _f64(P), _f64(Hm), _f64(nu), _f64(R))
    xn, Pn = tekf.normalise(xu, Pu)
    keep = _f64(np.concatenate([np.ones(13), np.repeat(~kill, 6)]))
    want_P = tekf.symmetrize(Pn * keep[:, None] * keep[None, :])
    _matrix_close(xo, (xn * keep).numpy(), CORE_TOL, "x'")
    _matrix_close(Po, want_P.numpy(), CORE_TOL, "P'")


def test_wrappers_take_the_plain_path_for_cpu_tensors():
    """A CPU tensor never reaches a kernel: the launch counts stay at 0."""
    _build.reset_launches()
    rng = np.random.default_rng(3)
    x, P, xpo, af, ap = _k1_scene(rng)
    p = P_STD
    predict_measure(torch.tensor(x), torch.tensor(P), torch.tensor(xpo), torch.tensor(af),
                    torch.tensor(ap), nsel=NSEL, maxp=1, dt=p.delta_t, sd_a=p.sd_a,
                    sd_alpha=p.sd_alpha, consts=MeasureConsts.from_params(p))
    assert set(_build.launches) >= {"predict_measure", "search", "ekf_update"}
    assert all(v == 0 for v in _build.launches.values())
