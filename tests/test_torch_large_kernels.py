"""The plain versions of K14, and of K2 and K4 at the hires shapes, against
the JAX package.

K14 (kernels/chol_inv.py::chol_linv, the plain version of csrc/chol_inv.cu)
against the TPU kernel pallas_linalg.py::pallas_chol_inv_lower in Pallas
interpret mode and against the f64 factorisation of core/ekf.py
(chol_unrolled / tril_inv_unrolled, held against the JAX package's in
tests/test_torch_core.py), on seeded SPD matrices and on EKF-shaped
S = H P H' + R whose missed rows are identity blocks. The interpret-mode
trace of the unrolled recurrence grows as M^2 (on one core 3.5 s at M = 20,
42 s at 64, 266 s at 128), so the TPU kernel is run up to M = 20 (the
step's size) and the larger sizes, up to the kernel's limit of 128, are held
to f64 (and on the card to the kernel, chip_smoke.py).

K2 at the hires shapes (640x480, search radius 48: 107 x 107 windows) and
K4 with 200 particles (640x480, particle radius 52: the padded row of 256
lanes) against the interpret-mode TPU kernels, on random scenes and on the
inputs that the port's CPU replay of the hires sequence hands the wrappers.

Tolerances: K14's L^-1 within 1e-5 of its largest entry (the TPU kernel sums
the substitution's rows in its compiler's order; f64 differs by the f32
rounding of the recurrence, ~2e-7 of the largest entry on these matrices).
K2 and K4: decisions and integers exactly; K2's best within 2e-5 absolute;
K4's prediction rows within 1e-4 of each row's largest entry, best within
2e-5, probabilities and depth moments within 1e-5 relative (the reasons are
those of tests/test_torch_kernels.py and tests/test_torch_mapping_kernels.py).
"""

from __future__ import annotations

import contextlib
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels import correlate as jcorr
from scenelib2_tpu.kernels.pallas_linalg import pallas_chol_inv_lower
from scenelib2_tpu.kernels.pallas_search import fused_search_img_pad, pallas_elliptical_search_fused
from scenelib2_tpu.kernels.pallas_search_bayes import pallas_search_bayes
from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.core.ekf import chol_unrolled, tril_inv_unrolled
from scenelib2_torch.eval.synthetic import HIRES_OVERRIDES, HIRES_PARAMS, generate_dataset
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.chol_inv import chol_inv, chol_linv
from scenelib2_torch.kernels.search import SearchConsts, search, search_window_origin
from scenelib2_torch.kernels.search_bayes import MISS, SearchBayesConsts, search_bayes_plain
from scenelib2_torch.runtime.state import patch_row

P_HI = Params(**HIRES_PARAMS)
H, W, B = P_HI.cam_height, P_HI.cam_width, P_HI.boxsize
NSEL = P_HI.n_features_to_select
CAM = (P_HI.cam_fku, P_HI.cam_fkv, P_HI.cam_u0, P_HI.cam_v0, P_HI.cam_kd1)
SBC = SearchBayesConsts.from_params(P_HI)
K14_TOL = 1e-5
K2_BEST_ATOL = 2e-5
ROW_TOL = 1e-4
BEST_ATOL = 2e-5
PROB_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------- K14


def _spd(M: int, seed: int) -> np.ndarray:
    A = np.random.default_rng(seed).normal(size=(M, M))
    return (A @ A.T / M + np.eye(M) * 0.5).astype(np.float32)


def _ekf_s(seed: int) -> np.ndarray:
    """S = H P H' + R at M = 20 (NSEL 10, D = 109): the rows of missed
    features are zero in H with R = 1, so S holds identity blocks there."""
    g = np.random.default_rng(seed)
    D = 109
    A = g.normal(size=(D, D))
    P = A @ A.T / D * 1e-3 + np.eye(D) * 1e-4
    Hm = np.zeros((20, D))
    miss = np.array([False, True, False, False, True, False, False, False, True, False])
    for k in range(10):
        if not miss[k]:
            Hm[2 * k : 2 * k + 2, :7] = g.normal(size=(2, 7)) * 200.0
            Hm[2 * k : 2 * k + 2, 13 + 6 * k : 16 + 6 * k] = g.normal(size=(2, 3)) * 200.0
    R = np.diag(np.where(np.repeat(miss, 2), 1.0, g.uniform(1.0, 2.0, 20)))
    S = (Hm @ P @ Hm.T + R).astype(np.float32)
    assert (S[2:4, 2:4] == np.eye(2)).all() and (S[2:4, :2] == 0).all()
    return S


K14_JAX_CASES = [("spd", 1), ("spd", 2), ("spd", 7), ("spd", 20), ("ekf", 20)]


def _k14_case(kind, M):
    return _ekf_s(M) if kind == "ekf" else _spd(M, M)


def _close(got, want, tol, what):
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, f"{what}: max abs err {err} > {tol} x {scale}"


@pytest.mark.parametrize("kind,M", K14_JAX_CASES)
def test_k14_plain_matches_pallas(kind, M):
    S = _k14_case(kind, M)
    want = np.asarray(pallas_chol_inv_lower(jnp.asarray(S), interpret=True))
    got = chol_linv(torch.tensor(S)).numpy()
    _close(got, want, K14_TOL, f"{kind} M={M}")
    assert (np.triu(got, 1) == 0).all()


@pytest.mark.parametrize("kind,M", K14_JAX_CASES + [("spd", 64), ("spd", 128)])
def test_k14_plain_matches_f64_factorisation(kind, M):
    S = _k14_case(kind, M)
    X = tril_inv_unrolled(chol_unrolled(torch.tensor(S, dtype=torch.float64))).numpy()
    got = chol_linv(torch.tensor(S)).numpy()
    _close(got, X, K14_TOL, f"{kind} M={M}")
    # and L^-1 S L^-T is the identity
    np.testing.assert_allclose(X @ S.astype(np.float64) @ X.T, np.eye(M), rtol=0, atol=1e-5)


def test_k14_stack_is_each_matrix_alone():
    """A leading dimension is a stack of independent matrices (one block
    each on the card): each entry is what the matrix gives alone."""
    S = np.stack([_spd(20, s) for s in (3, 4, 5)])
    got = chol_linv(torch.tensor(S))
    for i in range(3):
        assert torch.equal(got[i], chol_linv(torch.tensor(S[i])))
    _build.reset_launches()
    assert torch.equal(chol_inv(torch.tensor(S)), got)
    assert all(v == 0 for v in _build.launches.values())


# ---------------------------------------------------------------------- K2 at hires


@pytest.fixture(scope="module")
def hires_inputs(tmp_path_factory):
    """A hires frame, and the K2 / K4 wrappers' inputs on output indices
    0..11 of the port's CPU replay of the hires sequence (inits at 3, 5, 7,
    11; the first conversion at 10)."""
    import scenelib2_torch.runtime.step as step_mod

    frames, _, _, cfg = generate_dataset(str(tmp_path_factory.mktemp("hires")), n_frames=13,
                                         seed=7, params=P_HI)
    slam = MonoSLAM(cfg, device="cpu", **HIRES_OVERRIDES)
    store, frame_no = {}, [0]
    orig = {n: getattr(step_mod, n) for n in ("search", "search_bayes")}

    def wrap(n):
        def call(*a, **k):
            store[(n, frame_no[0])] = a
            return orig[n](*a, **k)
        return call

    with contextlib.ExitStack() as stack:
        for n in orig:
            setattr(step_mod, n, wrap(n))
            stack.callback(setattr, step_mod, n, orig[n])
        for t in range(1, 13):
            frame_no[0] = t - 1
            slam.go_one_step(frames[t], enable_mapping=True)
    return frames, store


def _k2_scene(rng, img):
    centres = np.stack([rng.uniform(30, W - 30, NSEL), rng.uniform(30, H - 30, NSEL)], 1)
    patches = []
    for k in range(NSEL):
        u = int(np.clip(round(centres[k, 0] + rng.integers(-4, 5)), 5, W - 6))
        v = int(np.clip(round(centres[k, 1] + rng.integers(-4, 5)), 5, H - 6))
        patches.append(img[v - 5 : v + 6, u - 5 : u + 6])
    sinv = []
    for _ in range(NSEL):
        s = rng.uniform(1.0, 160.0, 2)
        rho = rng.uniform(-0.6, 0.6)
        c = rho * math.sqrt(s[0] * s[1])
        sinv.append(np.linalg.inv(np.array([[s[0], c], [c, s[1]]])))
    active = rng.uniform(size=NSEL) > 0.2
    # the last feature at the frame's corner: the window clamps to the edge
    centres[-1] = (W - 2.0, H - 3.0)
    active[-1] = True
    return centres.astype(np.float32), np.stack(patches), np.stack(sinv).astype(np.float32), active


@pytest.mark.parametrize("case", ["random", "tie", "real_frame"])
def test_k2_plain_matches_pallas_at_hires(case, hires_inputs):
    rng = np.random.default_rng(["random", "tie", "real_frame"].index(case) + 41)
    if case == "tie":
        tile = rng.integers(0, 256, size=(B, B), dtype=np.uint8)
        img = np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy()
    elif case == "real_frame":
        img = hires_inputs[0][5]
    else:
        img = rng.integers(0, 256, size=(H, W), dtype=np.uint8)
    centres, patches, sinv, active = _k2_scene(rng, img)
    rows = np.stack([patch_row(torch.tensor(np.ascontiguousarray(p))).numpy() for p in patches])
    R = P_HI.search_win_radius
    ju0, jv0, _, _ = jcorr.search_window_origin(jnp.asarray(centres), R, W, H, B, round_half=True)
    want = pallas_elliptical_search_fused(
        jnp.asarray(img), None, ju0, jv0, jnp.asarray(centres), jnp.asarray(sinv),
        jnp.asarray(active), image_shape=(H, W), boxsize=B, win_radius=R,
        no_sigma=P_HI.no_sigma, corr_thresh2=P_HI.corr_thresh2,
        corr_sigma_thresh=P_HI.corr_sigma_thresh, interpret=True, patch_rows=jnp.asarray(rows))
    u0, v0, uc, vc = search_window_origin(torch.tensor(centres), R, W, H, B)
    np.testing.assert_array_equal(u0.numpy(), np.asarray(ju0))
    np.testing.assert_array_equal(v0.numpy(), np.asarray(jv0))
    sc = SearchConsts.from_params(P_HI)
    assert (sc.side_u + B - 1, sc.side_v + B - 1) == (107, 107)
    abc = torch.tensor(np.stack([sinv[:, 0, 0], sinv[:, 0, 1], sinv[:, 1, 1]], 1))
    got = search(torch.tensor(img), torch.tensor(rows), u0, v0, uc, vc, abc, torch.tensor(active), sc)
    found, u, v, best, over = (t.numpy() for t in got)
    wfound, wu, wv, wbest, wover = (np.asarray(t) for t in want)
    np.testing.assert_array_equal(found, wfound)
    np.testing.assert_array_equal(over, wover)
    np.testing.assert_array_equal(u, wu)
    np.testing.assert_array_equal(v, wv)
    np.testing.assert_allclose(best, wbest, rtol=0, atol=K2_BEST_ATOL)
    if case != "random":
        assert found.any()


def test_k2_plain_matches_pallas_on_the_hires_replay(hires_inputs):
    """The selected features of three frames of the port's hires replay."""
    _frames, store = hires_inputs
    R = P_HI.search_win_radius
    for t in (0, 4, 10):
        frame, rows, u0, v0, uc, vc, abc, active, sc = store[("search", t)]
        h = torch.stack([uc, vc], 1).to(torch.float32)
        sinv = torch.stack([abc[:, 0], abc[:, 1], abc[:, 1], abc[:, 2]], 1).reshape(-1, 2, 2)
        want = pallas_elliptical_search_fused(
            jnp.asarray(frame.numpy()), None, jnp.asarray(u0.numpy()), jnp.asarray(v0.numpy()),
            jnp.asarray(h.numpy()), jnp.asarray(sinv.numpy()), jnp.asarray(active.numpy()),
            image_shape=(H, W), boxsize=B, win_radius=R, no_sigma=P_HI.no_sigma,
            corr_thresh2=P_HI.corr_thresh2, corr_sigma_thresh=P_HI.corr_sigma_thresh,
            interpret=True, patch_rows=jnp.asarray(rows.numpy()))
        got = search(frame, rows, u0, v0, uc, vc, abc, active, sc)
        for name, g, w in zip(("found", "u", "v"), got[:3], want[:3]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"frame {t}: {name}")
        assert bool(got[0].any())


# ---------------------------------------------------------------------- K4 at hires


def _k4_jax(args):
    frame, prob, lam, palive, making, pmask, ma, pidx, prow, shared, slot_row, _c = args
    ph1, pw1 = fused_search_img_pad((H, W), boxsize=B, win_radius=P_HI.search_win_radius)
    img = np.zeros((max(ph1, (H + 7) // 8 * 8), max(pw1, (W + 127) // 128 * 128)), np.float32)
    img[:H, :W] = frame.numpy()
    res = pallas_search_bayes(
        jnp.asarray(img), None, jnp.asarray(prob.numpy()), jnp.asarray(lam.numpy()),
        jnp.asarray(palive.numpy()), jnp.asarray(making.numpy()), jnp.asarray(pmask.numpy()),
        jnp.asarray(ma.numpy()), pidx=jnp.int32(int(pidx[0])), patch_row=jnp.asarray(prow.numpy()),
        boxsize=B, corr_sigma_thresh=SBC.corr_sigma_thresh, low_sigma_penalty=SBC.low_sigma_penalty,
        shared=jnp.asarray(shared.numpy())[None], slot_rows=jnp.asarray(slot_row.numpy())[None],
        cam_static=CAM, sd0=P_HI.cam_sd, image_shape=(H, W), win_radius=SBC.win_radius,
        no_sigma=SBC.no_sigma, corr_thresh2=SBC.corr_thresh2,
        prune_prob_thresh=P_HI.prune_prob_thresh, sd_depth_ratio=P_HI.sd_depth_ratio,
        min_particles=P_HI.min_particles,
        erase_partial_after_attempts=P_HI.erase_partial_after_attempts, interpret=True)
    out = [np.asarray(r) for r in res]
    out[-1] = out[-1][:, :, : prob.shape[1]]
    return out


K4_CASES = ["making", "first_conversion", "overflow", "random_alive"]


def _k4_case(case, hires_inputs):
    at = {"first_conversion": 10}.get(case, 8)
    a = list(hires_inputs[1][("search_bayes", at)])
    g = np.random.default_rng(43)
    if case == "overflow":
        a[10] = a[10].clone()
        a[10][48:] = a[10][48:] * 400.0
    elif case == "random_alive":
        p = int(a[7][0])
        a[3] = a[3].clone()
        a[3][p] = torch.tensor(g.uniform(size=a[3].shape[1]) > 0.3)
        a[1] = a[1].clone()
        a[1][p] = torch.tensor(g.uniform(0.0, 0.02, a[1].shape[1]), dtype=torch.float32)
    return a


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_plain_matches_pallas_with_200_particles(case, hires_inputs):
    args = _k4_case(case, hires_inputs)
    assert args[1].shape == (60, 200) and bool(args[4][0])
    got = [t.numpy() for t in search_bayes_plain(*args)]
    want = _k4_jax(args)
    (prob, palive, mean, cov, convert, kill, n_over, found, z, best, pred) = got
    (wprob, walive, wmean, wcov, wconvert, wkill, wn_over, wfound, wz, wbest, wpred) = want
    for name, g_, w in (("palive", palive, walive), ("convert", convert, wconvert),
                        ("kill", kill, wkill), ("n_over", n_over, wn_over), ("found", found, wfound),
                        ("z", z, wz)):
        np.testing.assert_array_equal(g_, w, err_msg=f"{case}: {name}")
    np.testing.assert_array_equal(best >= MISS, wbest >= MISS, err_msg=case)
    np.testing.assert_allclose(best[best < MISS], wbest[wbest < MISS], rtol=0, atol=BEST_ATOL)
    scale = np.abs(wpred[0]).max(axis=1, keepdims=True)
    assert (np.abs(pred[0] - wpred[0]) <= ROW_TOL * scale).all(), case
    for name, g_, w in (("prob", prob, wprob), ("mean", mean, wmean), ("cov", cov, wcov)):
        np.testing.assert_allclose(g_, w, rtol=PROB_RTOL, atol=PROB_RTOL * np.abs(w).max(),
                                   err_msg=f"{case}: {name}")
    if case == "first_conversion":
        assert wconvert.all()
    elif case == "overflow":
        assert wn_over[0] > 0
    else:
        assert wfound.any()
