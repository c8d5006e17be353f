"""The particle kernels on rows wider than 128 lanes: the plain versions of
K10, K11, K12 (both row forms) and K4 at 200 and 300 particles, and K11 and
K12 at 5,120 (past the 4,096 that the kernels hold in shared memory: on the
card their workspace path), against the JAX Pallas kernels they port, run
in interpret mode in this process (pallas_particle.py::pallas_particle_predict_fused,
pallas_search_bayes.py::pallas_search_bayes in its pred-rows and merged
frame modes, pallas_bayes.py::pallas_bayes_update), on seeded slots: a
camera near the origin and rays near the optical axis, so that every depth
projects into the frame, on random maps and frames with a minimum planted
under the rays. The JAX kernels pad each row to a multiple of 128 lanes (256
and 384 here); the port's K10 rows have that width.

Tolerances, as at 100 particles (tests/test_torch_batch_kernels.py,
test_torch_mapping_kernels.py): integers, masks and decisions exactly; K10's
and K4's prediction rows within 1e-4 of each row's largest entry (XLA's CPU
f32 sqrt is off by an ulp at times); probabilities and moments within 1e-5
relative (the depth variance within 1e-5 of the squared mean); K4's best
within 2e-5 absolute. The sums over a row run in the port in a fixed tree
order over bayes.tree_width(NP) lanes (a 384-lane row as 512: a power of
two), in JAX in XLA's order; the tree itself is held to the definition.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_bayes import pallas_bayes_update
from scenelib2_tpu.kernels.pallas_particle import pallas_particle_predict_fused
from scenelib2_tpu.kernels.pallas_search_bayes import pallas_search_bayes
from scenelib2_torch.config import Params
from scenelib2_torch.kernels.bayes import BayesConsts, bayes_update_plain, padded_lanes, tree_sum, tree_width
from scenelib2_torch.kernels.particle import ParticleConsts, particle_predict_plain
from scenelib2_torch.kernels.search_bayes import SearchBayesConsts, search_bayes_maps_plain, search_bayes_plain
from scenelib2_torch.runtime.state import patch_row

P_STD = dataclasses.replace(Params(), max_features=16)
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize
CAM = (P_STD.cam_fku, P_STD.cam_fkv, P_STD.cam_u0, P_STD.cam_v0, P_STD.cam_kd1)
PCN = ParticleConsts.from_params(P_STD)
SBC = SearchBayesConsts.from_params(P_STD)
BC = BayesConsts.from_params(P_STD)
ROW_TOL = 1e-4
PROB_RTOL = 1e-5
BEST_ATOL = 2e-5
MISS = 1e6
WIDE = (200, 300)
LONG = 5120        # past the 4,096 particles the kernels hold in shared memory: their workspace path
NAMES = ("prob", "palive", "mean", "cov", "convert", "kill", "n_over", "found", "z", "best")
BAYES_KW = dict(prune_prob_thresh=P_STD.prune_prob_thresh, sd_depth_ratio=P_STD.sd_depth_ratio,
                min_particles=P_STD.min_particles,
                erase_partial_after_attempts=P_STD.erase_partial_after_attempts)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def j(t):
    return jnp.asarray(t.numpy() if isinstance(t, torch.Tensor) else t)


def _slots(rng, n):
    """(shared [56], slot rows [n, 84]) f32: a camera near the origin, rays
    near the optical axis, and one joint SPD covariance over the camera's
    first 7 dimensions and the n slots (1e-5 camera, 1e-4 slot scale)."""
    q = np.array([1.0, *rng.normal(0, 0.02, 3)])
    d = 7 + 6 * n
    M = rng.normal(size=(d, d))
    s = np.sqrt(np.r_[np.full(7, 1e-5), np.full(6 * n, 1e-4)])
    C = s[:, None] * (np.eye(d) + 0.5 * M @ M.T / d) * s[None, :]
    shared = np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()])
    rows = []
    for k in range(n):
        h = np.array([*rng.normal(0, 0.06, 2), 1.0])
        o = 7 + 6 * k
        rows.append(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, o : o + 6].ravel(),
                                    C[o : o + 6, o : o + 6].ravel()]))
    return torch.tensor(shared, dtype=torch.float32), torch.tensor(np.stack(rows), dtype=torch.float32)


def _lam(NP, n):
    return torch.tensor(np.tile(np.linspace(0.5, 5.0, NP), (n, 1)), dtype=torch.float32)


def _rows_close(got, want):
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    scale = np.where(fin, np.abs(want), 0.0).max(axis=-1, keepdims=True)
    assert (np.where(fin, np.abs(got - want), 0.0) <= ROW_TOL * np.maximum(scale, 1e-30)).all()


def _k10_jax(shared, slot, lam):
    return np.asarray(pallas_particle_predict_fused(
        j(slot[None, :6]), jnp.pad(j(slot[6:48]).reshape(1, 7, 6), ((0, 0), (0, 6), (0, 0))),
        j(slot[48:]).reshape(1, 6, 6), j(shared[:7]), j(shared[7:]).reshape(7, 7), j(lam[None]),
        fku=CAM[0], fkv=CAM[1], u0c=CAM[2], v0c=CAM[3], kd1=CAM[4], sd0=P_STD.cam_sd,
        no_sigma=P_STD.no_sigma, interpret=True, return_raw=True)[-1])[0]


def _close_probs(got, want, label):
    mean2 = float(np.abs(np.asarray(want[2])).max()) ** 2
    for n, g, w in zip(NAMES, got, want):
        g, w = np.asarray(g), np.asarray(w)
        if n in ("prob", "mean", "cov"):
            atol = PROB_RTOL * (mean2 if n == "cov" else max(float(np.abs(w).max()), 1e-30))
            np.testing.assert_allclose(g, w, rtol=PROB_RTOL, atol=atol, err_msg=f"{label}: {n}")
        elif n == "best":
            np.testing.assert_array_equal(g >= MISS, w >= MISS, err_msg=label)
            np.testing.assert_allclose(g[g < MISS], w[w < MISS], rtol=0, atol=BEST_ATOL, err_msg=label)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}: {n}")


@pytest.mark.parametrize("n", [1, 100, 128, 129, 200, 256, 300, 384, 1100])
def test_tree_sum_runs_the_pairwise_tree_over_a_power_of_two(n):
    """tree_width: the TPU kernel's padded row (128, 256, 384, ...) rounded
    up to a power of two; tree_sum adds lane i + s to lane i, s = width / 2,
    ..., 1, over zero padding (so 128 and 256 keep the order of 100 and 200
    particles)."""
    width = tree_width(n)
    assert width >= padded_lanes(n) >= n and width & (width - 1) == 0
    assert tree_width(n) == {1: 128, 100: 128, 128: 128, 129: 256, 200: 256, 256: 256, 300: 512,
                             384: 512, 1100: 2048}[n]
    v = torch.tensor(np.random.default_rng(n).uniform(0, 1, n), dtype=torch.float32)
    t = np.zeros(width, np.float32)
    t[:n] = v.numpy()
    while len(t) > 1:
        t = t[: len(t) // 2] + t[len(t) // 2 :]
    assert tree_sum(v).numpy() == t[0]


@pytest.mark.parametrize("NP", WIDE)
def test_k10_rows_match_pallas_at_wide_rows(NP):
    rng = np.random.default_rng(NP)
    shared, slots = _slots(rng, 2)
    lam = _lam(NP, 2)
    got = particle_predict_plain(shared[None].expand(2, 56), slots[:, None], lam[:, None], PCN).numpy()
    assert got.shape == (2, 1, 8, padded_lanes(NP))
    for b in range(2):
        want = _k10_jax(shared.numpy(), slots[b].numpy(), lam[b].numpy())
        assert want.shape == (8, padded_lanes(NP))
        _rows_close(got[b, 0], want)
    # the padding lanes hold the chain at lambda = 1
    pad = particle_predict_plain(shared[None], slots[:1, None], torch.ones((1, 1, 1)), PCN)[0, 0, :, 0]
    assert torch.equal(torch.from_numpy(got[0, 0, :, -1]), pad)


def _k11_case(NP, making=True):
    rng = np.random.default_rng(1000 + NP)
    n = 2
    shared, slots = _slots(rng, n)
    lam = _lam(NP, n)[:, None]
    pred = particle_predict_plain(shared[None].expand(n, 56), slots[:, None], lam, PCN)
    maps = torch.tensor(rng.uniform(0.3, 2.0, (n, 1, H, W)), dtype=torch.float32)
    for b in range(n):
        u = int(pred[b, 0, 0, NP // 2].clamp(3, W - 4))
        v = int(pred[b, 0, 1, NP // 2].clamp(3, H - 4))
        maps[b, 0, v - 2 : v + 2, u - 2 : u + 2] = torch.tensor(rng.uniform(0.05, 0.2, (4, 4)))
    alive = torch.tensor(rng.uniform(size=(n, 1, NP)) > 0.1)
    prob = torch.tensor(rng.uniform(0.5, 1.5, (n, 1, NP)) / NP, dtype=torch.float32)
    flags = torch.full((n, 1), making), torch.ones((n, 1), dtype=torch.bool)
    return (maps, pred, prob, lam, alive, *flags, torch.full((n, 1), 3, dtype=torch.int32), SBC)


@pytest.mark.parametrize("making", [True, False])
@pytest.mark.parametrize("NP", WIDE + (LONG,))
def test_k11_matches_pallas_at_wide_rows(NP, making):
    a = _k11_case(NP, making)
    got = search_bayes_maps_plain(*a)
    for b in range(a[0].shape[0]):
        want = pallas_search_bayes(
            j(a[0][b]), j(a[1][b]), j(a[2][b]), j(a[3][b]), j(a[4][b]), j(a[5][b]), j(a[6][b]), j(a[7][b]),
            image_shape=(H, W), win_radius=SBC.win_radius, no_sigma=SBC.no_sigma,
            corr_thresh2=SBC.corr_thresh2, interpret=True, **BAYES_KW)
        _close_probs([g[b] for g in got], want, f"K11 NP={NP} lane {b}")
        if making:
            assert np.asarray(want[7]).any()
        else:
            assert not np.asarray(want[7]).any()


@pytest.mark.parametrize("form", ["rows13", "pred_rows"])
@pytest.mark.parametrize("NP", WIDE + (LONG,))
def test_k12_matches_pallas_at_wide_rows(NP, form):
    rng = np.random.default_rng(2000 + NP)
    F = 4
    f32 = torch.float32
    prob = torch.tensor(rng.uniform(0.5, 1.5, (F, NP)) / NP, dtype=f32)
    lam = _lam(NP, F)
    palive = torch.tensor(rng.uniform(size=(F, NP)) > 0.1)
    found = torch.tensor(rng.uniform(size=(F, NP)) > 0.6) & palive
    p_over = torch.tensor(rng.uniform(size=(F, NP)) > 0.95) & ~found
    found[1] = False
    p_over[1] = False
    hpi = torch.tensor(rng.uniform(100, 115, (F, NP, 2)), dtype=f32)
    z = hpi + torch.tensor(rng.normal(0, 1.5, (F, NP, 2)), dtype=f32)
    sinv = torch.tensor(np.tile([[0.05, 0.01], [0.01, 0.04]], (F, NP, 1, 1)), dtype=f32)
    dets = torch.tensor(rng.uniform(300, 600, (F, NP)), dtype=f32)
    making = torch.tensor([True, True, True, False])
    pmask = torch.ones(F, dtype=torch.bool)
    ma = torch.tensor([3, 3, P_STD.erase_partial_after_attempts + 1, 3], dtype=torch.int32)
    pred = None
    if form == "pred_rows":
        pred = torch.zeros((F, 8, padded_lanes(NP)), dtype=f32)
        pred[:, 0, :NP], pred[:, 1, :NP] = hpi[..., 0], hpi[..., 1]
        pred[:, 2, :NP], pred[:, 3, :NP], pred[:, 4, :NP] = sinv[..., 0, 0], sinv[..., 0, 1], sinv[..., 1, 1]
        pred[:, 5, :NP] = dets
        pred[:, :, NP:] = 7.25              # padding lanes: no sum reads them
        hpi, sinv, dets = None, None, None
    args = (prob, lam, palive, found, p_over, z, hpi, sinv, dets, making, pmask, ma)
    got = bayes_update_plain(*args, BC, pred_rows=pred)
    zeros = (torch.zeros((F, NP, 2)), torch.zeros((F, NP, 2, 2)), torch.zeros((F, NP)))
    jargs = [j(t) for t in args[:6] + (zeros if pred is not None else args[6:9]) + args[9:]]
    want = pallas_bayes_update(*jargs, interpret=True, pred_rows=None if pred is None else j(pred), **BAYES_KW)
    _close_probs(got, want, f"K12 {form} NP={NP}")
    assert np.asarray(want[5])[1] and np.asarray(want[5])[2]       # the all-zero row and the sell-by die


def _k4_case(NP, case):
    rng = np.random.default_rng(3000 + NP)
    shared, slots = _slots(rng, 1)
    MF = 4
    frame = torch.tensor(rng.integers(0, 256, (H, W), dtype=np.uint8))
    pred = particle_predict_plain(shared[None], slots[None], _lam(NP, 1)[None], PCN)
    u = int(pred[0, 0, 0, NP // 2].clamp(20, W - 21))
    v = int(pred[0, 0, 1, NP // 2].clamp(20, H - 21))
    patch = frame[v - B // 2 : v + B // 2 + 1, u - B // 2 : u + B // 2 + 1]
    alive = torch.tensor(rng.uniform(size=(MF, NP)) > 0.1)
    slot = slots[0]
    if case == "overflow":
        slot = slot.clone()
        slot[48:] = slot[48:] * 400.0
    return (frame, torch.full((MF, NP), 1.0 / NP), _lam(NP, MF), alive, torch.tensor([case != "making_false"]),
            torch.tensor([True]), torch.tensor([3], dtype=torch.int32), torch.tensor([1], dtype=torch.int32),
            patch_row(patch), shared, slot, SBC)


def _k4_jax(args, NP):
    frame, prob, lam, palive, making, pmask, ma, pidx, prow, shared, slot_row, _c = args
    img = np.zeros((H, 384), np.float32)
    img[:, :W] = frame.numpy()
    res = pallas_search_bayes(
        jnp.asarray(img), None, j(prob), j(lam), j(palive), j(making), j(pmask), j(ma),
        pidx=jnp.int32(int(pidx[0])), patch_row=j(prow), boxsize=B, corr_sigma_thresh=SBC.corr_sigma_thresh,
        low_sigma_penalty=SBC.low_sigma_penalty, shared=j(shared)[None], slot_rows=j(slot_row)[None],
        cam_static=CAM, sd0=P_STD.cam_sd, image_shape=(H, W), win_radius=SBC.win_radius,
        no_sigma=SBC.no_sigma, corr_thresh2=SBC.corr_thresh2, interpret=True, **BAYES_KW)
    out = [np.asarray(r) for r in res]
    assert out[-1].shape[-1] == padded_lanes(NP)
    out[-1] = out[-1][:, :, :NP]
    return out


@pytest.mark.parametrize("case", ["steady", "overflow", "making_false"])
@pytest.mark.parametrize("NP", WIDE)
def test_k4_matches_pallas_at_wide_rows(NP, case):
    args = _k4_case(NP, case)
    got = [t.numpy() for t in search_bayes_plain(*args)]
    want = _k4_jax(args, NP)
    _close_probs(got[:10], want[:10], f"K4 NP={NP} {case}")
    assert got[10].shape == (1, 8, NP)
    _rows_close(got[10][0], want[10][0])
    if case == "steady":
        assert want[7].any()
    elif case == "overflow":
        assert want[6][0] > 0
    else:
        assert not want[7].any()


@pytest.mark.parametrize("NP", [LONG, 16384])
def test_step_builders_take_rows_past_the_shared_memory_path(NP):
    """No particle limit: the single-stream step and the three batch routes
    build at NP past bayes.CHUNK_NP, and the kernels' workspace is sized as
    csrc/search_bayes.cu's per-block arrays (8 prediction rows, best, key,
    the tree)."""
    from scenelib2_torch.kernels.bayes import CHUNK_NP
    from scenelib2_torch.kernels.search_bayes import wide_workspace
    from scenelib2_torch.parallel.mesh import make_batched_step
    from scenelib2_torch.runtime.step import make_step

    p = dataclasses.replace(Params(), n_particles=NP)
    make_step(p, device="cpu")
    make_batched_step(p, device="cpu")
    make_batched_step(p, device="cpu", batch_sb=False)
    make_batched_step(dataclasses.replace(p, batch_pallas=False), device="cpu")
    assert NP > CHUNK_NP and wide_workspace(3, CHUNK_NP, "cpu") is None
    assert wide_workspace(3, NP, "cpu").shape == (3, 10 * NP + tree_width(NP))
