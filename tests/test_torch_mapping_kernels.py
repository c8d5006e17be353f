"""The plain versions of K5, K6 and K4 against the JAX Pallas kernels.

Each plain PyTorch version (what a CPU tensor runs through the kernel
wrapper) is held against the TPU kernel it ports, run in Pallas interpret
mode in this process, on the same inputs: the inputs that the port's own
CPU replay of the std synthetic sequence hands each wrapper on real frames
(the first init at output index 9, the first conversion at 20), and seeded
variations that reach the other cases (no attempt, no room, every try
clashing, a flat region, a built tie, making false, an empty union box,
overflowing particles, a sell-by kill).

Tolerances: integers and decisions exactly (regions, limbs, positions,
found, z, masks, convert, kill, overflow counts). K6's eigenvalue within
1e-5 relative. K4's eight prediction rows, the determinant included, within
1e-4 of each row's largest entry: the chain is the TPU kernel's operation
for operation (its slot prologue agrees bit for bit), but XLA's f32 sqrt on
the CPU is off by an ulp where PyTorch's and CUDA's are correctly rounded,
and the inverse's cancellations and the determinant's difference magnify
that ulp (so the determinant is not held to 2 ulp of itself; on the card
the kernel and its twin agree bit for bit, chip_smoke.py). K4's NSSD best
within 2e-5 absolute (a perfect match leaves the rounding residue of a
cancelling sum); K4's probabilities and depth moments within 1e-5 relative
(the TPU kernel sums its 128 lanes in another order than the port's tree).
"""

from __future__ import annotations

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_propose import pallas_propose_init
from scenelib2_tpu.kernels.pallas_search_bayes import pallas_search_bayes
from scenelib2_tpu.kernels.pallas_shi_tomasi import pallas_shi_tomasi_region
from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.kernels import _build
from scenelib2_torch.kernels.propose import (
    ProposeConsts,
    init_gate,
    propose_plain,
    propose_region,
    propose_region_plain,
)
from scenelib2_torch.kernels.search_bayes import MISS, SearchBayesConsts, search_bayes_plain
from scenelib2_torch.kernels.shi_tomasi import clamp_region, shi_tomasi_plain

P_STD = Params()
H, W, B = P_STD.cam_height, P_STD.cam_width, P_STD.boxsize
CAM = (P_STD.cam_fku, P_STD.cam_fkv, P_STD.cam_u0, P_STD.cam_v0, P_STD.cam_kd1)
RW, RH = P_STD.init_search_width, P_STD.init_search_height
PC = ProposeConsts.from_params(P_STD)
SBC = SearchBayesConsts.from_params(P_STD)
EV_RTOL = 1e-5
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


@contextlib.contextmanager
def _capture(store: dict, frame_no: list):
    """Record the arguments of the step's K4-K6 wrappers, by frame. K5's
    step form (propose_region) is also stored under "propose" with the JAX
    kernel's arguments: the active full slots and the step's gate."""
    import scenelib2_torch.runtime.step as step_mod

    names = ("propose_region", "shi_tomasi", "search_bayes")
    orig = {n: getattr(step_mod, n) for n in names}

    def wrap(n):
        def call(*a, **k):
            store[(n, frame_no[0])] = (a, k)
            if n == "propose_region":
                x, rng, active, full, speed, n_visible, c = a
                store[("propose", frame_no[0])] = (
                    (x, rng, active & full, init_gate(active, full, speed, n_visible, c), c), k)
            return orig[n](*a, **k)
        return call

    for n in names:
        setattr(step_mod, n, wrap(n))
    try:
        yield
    finally:
        for n in names:
            setattr(step_mod, n, orig[n])


@pytest.fixture(scope="module")
def real_inputs(tmp_path_factory):
    """The wrappers' inputs on output indices 0..29 of the port's CPU replay
    of the std sequence, mapping on."""
    frames, _, _, cfg = generate_dataset(str(tmp_path_factory.mktemp("std")), n_frames=31, seed=7)
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    store, frame_no = {}, [0]
    with _capture(store, frame_no):
        for t in range(1, 31):
            frame_no[0] = t - 1
            slam.go_one_step(frames[t], enable_mapping=True)
    return store


# ---------------------------------------------------------------------- K5


def _k5_jax(x, rng, occ, want):
    us, vs, ok, rng_new = pallas_propose_init(
        jnp.asarray(x.numpy()), jnp.asarray(rng.numpy().astype(np.uint32)), jnp.asarray(occ.numpy()),
        jnp.asarray(bool(want)), image_shape=(H, W), region_w_cfg=RW, region_h_cfg=RH, boxsize=B,
        tries=PC.tries, sep=PC.sep, dtN=PC.dtN, depth=PC.depth, cam_static=CAM, interpret=True)
    return int(us), int(vs), bool(ok), np.asarray(rng_new).astype(np.int64)


def _k5_case(case, real_inputs):
    a, _ = real_inputs[("propose", 9)]
    x, rng, occ, want, _c = a
    x = x.clone()
    if case == "first_init":
        assert bool(want)
    elif case == "want_false":
        want = torch.tensor(False)
    elif case == "no_room":
        # a fast fall: the future point projects near the bottom edge, and
        # the safe box is shorter than a region
        x[7:10] = torch.tensor([0.0, -20.0, 0.0])
    elif case == "all_clash":
        # occupied points on a grid over the whole view: every region clashes
        MF = occ.shape[0]
        g = np.random.default_rng(5)
        occ = torch.ones(MF, dtype=torch.bool)
        xs = np.linspace(-0.9, 0.9, 4)
        ys = np.linspace(-0.6, 0.6, 4)
        pts = np.array([[u, v] for u in xs for v in ys])
        for k in range(MF):
            x[13 + 6 * k : 16 + 6 * k] = x[0:3] + torch.tensor(
                [pts[k, 0], pts[k, 1], 2.0 + g.uniform(-0.1, 0.1)], dtype=torch.float32)
    elif case == "seeded":
        g = np.random.default_rng(11)
        rng = torch.tensor(g.integers(0, 1 << 16, 3), dtype=torch.int32)
        x[7:13] = x[7:13] + torch.tensor(g.normal(0, 0.05, 6), dtype=torch.float32)
    return x, rng, occ, want


@pytest.mark.parametrize("case", ["first_init", "want_false", "no_room", "all_clash", "seeded"])
def test_k5_plain_matches_pallas(case, real_inputs):
    x, rng, occ, want = _k5_case(case, real_inputs)
    us, vs, ok, rng_new = propose_plain(x, rng, occ, want, PC)
    want_us, want_vs, want_ok, want_rng = _k5_jax(x, rng, occ, want)
    assert (int(us), int(vs), bool(ok)) == (want_us, want_vs, want_ok), case
    np.testing.assert_array_equal(rng_new.numpy(), want_rng)
    consumed_none = np.array_equal(rng_new.numpy(), rng.numpy())
    if case == "first_init":
        assert want_ok and not consumed_none
    elif case in ("want_false", "no_room"):
        assert not want_ok and consumed_none
    elif case == "all_clash":
        # all ten draws consumed, no region
        assert not want_ok
        from scenelib2_torch.rng import drand48_many

        np.testing.assert_array_equal(rng_new.numpy(), drand48_many(rng, 10)[0][-1].numpy())


# ---------------------------------------------------------------------- K6


def _k6_jax(frame, bounds):
    ub, vb, ev = pallas_shi_tomasi_region(
        jnp.asarray(frame.numpy()), *(jnp.int32(int(b)) for b in bounds), boxsize=B,
        image_shape=(H, W), region_w=RW, region_h=RH, interpret=True)
    return int(ub), int(vb), float(ev)


def _k6_case(case, real_inputs):
    a, _ = real_inputs[("shi_tomasi", 9)]
    frame, ru, rv, ruf, rvf = a
    g = np.random.default_rng(21)
    if case == "flat":
        frame = torch.full_like(frame, 117)
    elif case == "tie":
        # a periodic texture: equal eigenvalues recur every period, so the
        # maximum is tied and the smallest scan key must win
        tile = g.integers(0, 256, (7, 9), dtype=np.uint8)
        frame = torch.tensor(np.tile(tile, (H // 7 + 1, W // 9 + 1))[:H, :W].copy())
    elif case == "border":
        frame = torch.tensor(g.integers(0, 256, (H, W), dtype=np.uint8))
        ru, rv, ruf, rvf = clamp_region(torch.tensor(250, dtype=torch.int32),
                                        torch.tensor(3, dtype=torch.int32),
                                        torch.tensor(250 + RW, dtype=torch.int32),
                                        torch.tensor(3 + RH, dtype=torch.int32), W, H, B)
    return frame, (ru, rv, ruf, rvf)


@pytest.mark.parametrize("case", ["first_init", "flat", "tie", "border"])
def test_k6_plain_matches_pallas(case, real_inputs):
    frame, bounds = _k6_case(case, real_inputs)
    ub, vb, ev = shi_tomasi_plain(frame, *bounds, boxsize=B, region_w=RW, region_h=RH)
    want_ub, want_vb, want_ev = _k6_jax(frame, bounds)
    assert (int(ub), int(vb)) == (want_ub, want_vb), case
    assert abs(float(ev) - want_ev) <= EV_RTOL * max(abs(want_ev), 1.0)
    if case == "flat":
        assert want_ev == 0.0 and (want_ub, want_vb) == (int(bounds[0]), int(bounds[1]))
    if case == "first_init":
        assert want_ev > P_STD.init_patch_score_thresh


def test_k6_tie_takes_the_first_cell_in_scan_order():
    """Two identical blobs side by side in the region: the left one (the
    smaller v*W + u on the same rows) wins, in the plain version and in the
    TPU kernel."""
    frame = np.full((H, W), 100, np.uint8)
    blob = np.random.default_rng(3).integers(0, 256, (15, 15), dtype=np.uint8)
    frame[70:85, 120:135] = blob
    frame[70:85, 155:170] = blob
    t = torch.tensor(frame)
    bounds = clamp_region(*(torch.tensor(v, dtype=torch.int32) for v in (110, 50, 190, 130)), W, H, B)
    ub, vb, ev = shi_tomasi_plain(t, *bounds, boxsize=B, region_w=RW, region_h=RH)
    assert _k6_jax(t, bounds)[:2] == (int(ub), int(vb))
    assert int(ub) < 145 and float(ev) > 0


# ---------------------------------------------------------------------- K4


def _k4_jax(args):
    frame, prob, lam, palive, making, pmask, ma, pidx, patch_row, shared, slot_row, _c = args
    img = np.zeros((H, 384), np.float32)
    img[:, :W] = frame.numpy()
    res = pallas_search_bayes(
        jnp.asarray(img), None, jnp.asarray(prob.numpy()), jnp.asarray(lam.numpy()),
        jnp.asarray(palive.numpy()), jnp.asarray(making.numpy()), jnp.asarray(pmask.numpy()),
        jnp.asarray(ma.numpy()), pidx=jnp.int32(int(pidx[0])), patch_row=jnp.asarray(patch_row.numpy()),
        boxsize=B, corr_sigma_thresh=SBC.corr_sigma_thresh, low_sigma_penalty=SBC.low_sigma_penalty,
        shared=jnp.asarray(shared.numpy())[None], slot_rows=jnp.asarray(slot_row.numpy())[None],
        cam_static=CAM, sd0=P_STD.cam_sd, image_shape=(H, W), win_radius=SBC.win_radius,
        no_sigma=SBC.no_sigma, corr_thresh2=SBC.corr_thresh2,
        prune_prob_thresh=P_STD.prune_prob_thresh, sd_depth_ratio=P_STD.sd_depth_ratio,
        min_particles=P_STD.min_particles,
        erase_partial_after_attempts=P_STD.erase_partial_after_attempts, interpret=True)
    out = [np.asarray(r) for r in res]
    out[-1] = out[-1][:, :, : prob.shape[1]]
    return out


def _k4_case(case, real_inputs):
    at = {"first_conversion": 20, "tie": 20}.get(case, 16)
    a, _ = real_inputs[("search_bayes", at)]
    a = list(a)
    g = np.random.default_rng(31)
    if case == "making_false":
        a[4] = torch.tensor([False])
    elif case == "empty_union":
        a[3] = torch.zeros_like(a[3])
    elif case == "overflow":
        # a wide slot covariance: 3-sigma extents beyond the window radius
        a[10] = a[10].clone()
        a[10][48:] = a[10][48:] * 400.0
    elif case == "sell_by":
        a[6] = torch.tensor([P_STD.erase_partial_after_attempts + 1], dtype=torch.int32)
    elif case == "random_alive":
        p = int(a[7][0])
        a[3] = a[3].clone()
        a[3][p] = torch.tensor(g.uniform(size=a[3].shape[1]) > 0.3)
        a[1] = a[1].clone()
        a[1][p] = torch.tensor(g.uniform(0.0, 0.02, a[1].shape[1]), dtype=torch.float32)
    elif case == "tie":
        # a periodic frame: the NSSD minimum recurs every period inside a
        # particle's ellipse, so the largest u*H + v among the ties decides
        tile = g.integers(0, 256, (B, B), dtype=np.uint8)
        a[0] = torch.tensor(np.tile(tile, (H // B + 1, W // B + 1))[:H, :W].copy())
        pr = a[8].clone()
        pr[: B * B] = torch.tensor(tile.reshape(-1), dtype=torch.float32)
        pr[B * B] = pr[: B * B].sum()
        pr[B * B + 1] = (pr[: B * B] ** 2).sum()
        a[8] = pr
    return a


K4_CASES = ["steady", "first_conversion", "making_false", "empty_union", "overflow", "sell_by",
            "random_alive", "tie"]


@pytest.mark.parametrize("case", K4_CASES)
def test_k4_plain_matches_pallas(case, real_inputs):
    args = _k4_case(case, real_inputs)
    got = [t.numpy() for t in search_bayes_plain(*args)]
    want = _k4_jax(args)
    (prob, palive, mean, cov, convert, kill, n_over, found, z, best, pred) = got
    (wprob, walive, wmean, wcov, wconvert, wkill, wn_over, wfound, wz, wbest, wpred) = want
    for name, g, w in (("palive", palive, walive), ("convert", convert, wconvert),
                       ("kill", kill, wkill), ("n_over", n_over, wn_over), ("found", found, wfound),
                       ("z", z, wz)):
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")
    np.testing.assert_array_equal(best >= MISS, wbest >= MISS, err_msg=case)
    np.testing.assert_allclose(best[best < MISS], wbest[wbest < MISS], rtol=0, atol=BEST_ATOL)
    scale = np.abs(wpred[0]).max(axis=1, keepdims=True)
    assert (np.abs(pred[0] - wpred[0]) <= ROW_TOL * scale).all(), case
    for name, g, w in (("prob", prob, wprob), ("mean", mean, wmean), ("cov", cov, wcov)):
        np.testing.assert_allclose(g, w, rtol=PROB_RTOL, atol=PROB_RTOL * np.abs(w).max(),
                                   err_msg=f"{case}: {name}")
    if case == "first_conversion":
        assert wconvert.all()
    elif case in ("making_false", "empty_union"):
        assert not wfound.any() and (wbest >= MISS).all()
    elif case == "overflow":
        assert wn_over[0] > 0
    elif case == "sell_by":
        assert wkill.all()
    elif case == "steady":
        assert wfound.any()


def test_k4_tie_breaks_to_the_largest_key(real_inputs):
    """On the periodic frame a found particle's minimum recurs inside its
    ellipse, and its match is the tied cell with the largest u*H + v (the
    plain version checked by brute force here; against the TPU kernel in
    test_k4_plain_matches_pallas[tie])."""
    from scenelib2_torch.kernels.particle import ROW_HH, ROW_HU, ROW_HV, ROW_HW, ROW_S01, ROW_S00, ROW_S11
    from scenelib2_torch.kernels.search_bayes import score_block

    args = _k4_case("tie", real_inputs)
    *_rest, found, z, best, pred = search_bayes_plain(*args)
    scores = score_block(args[0], args[8], 0, H, 0, W, SBC).numpy()
    n_tied = 0
    for p in torch.nonzero(found[0]).flatten().tolist():
        hu, hv, a, b, c, hw, hh = (np.float32(pred[0, r, p]) for r in (
            ROW_HU, ROW_HV, ROW_S00, ROW_S01, ROW_S11, ROW_HW, ROW_HH))
        uc, vc = np.trunc(hu), np.trunc(hv)
        u0 = min(max(uc - 32, 0), W - 65)
        v0 = min(max(vc - 32, 0), H - 65)
        vv, uu = np.mgrid[0:H, 0:W].astype(np.float32)
        urel, vrel = uu - uc, vv - vc
        ell = ((a * urel) * urel + ((np.float32(2) * b) * urel) * vrel) + (c * vrel) * vrel < 9
        box = ((vv >= max(v0, vc - hh)) & (vv < min(v0 + 65, vc + hh + 1))
               & (uu >= max(u0, uc - hw)) & (uu < min(u0 + 65, uc + hw + 1)))
        tied = box & ell & (scores == np.float32(best[0, p]))
        keys = (uu * H + vv)[tied]
        assert keys.size >= 1 and z[0, p, 0] * H + z[0, p, 1] == keys.max()
        n_tied += keys.size > 1
    assert n_tied > 0


def test_wrappers_route_cpu_tensors_to_the_plain_versions(real_inputs):
    a, _ = real_inputs[("propose_region", 9)]
    _build.reset_launches()
    got = propose_region(*a)
    want = propose_region_plain(*a)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(v == 0 for v in _build.launches.values())
