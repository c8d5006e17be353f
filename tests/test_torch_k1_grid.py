"""The premises of K1's grid (csrc/predict_measure.cu), held on the CPU
through Python mirrors of the kernel's steps, kept here (unit_map,
assemble, ballot_tail; a change to predict_measure.cu's steps changes its
mirror here):

(a) the copy CTAs' flat map of 16-byte units writes every element of P'
    outside the camera block exactly once, CTA 0 the camera block, at
    D = 19, 109, 373 and 379 (odd D: rows not 16-byte aligned), with the
    wrapper's CTA count and forced ones, on the float4 path and the scalar
    one; P' assembled through the map from the twin's pieces (Pc, the
    camera rows F P, their transpose, P) is the twin's P' bit for bit;
(b) n_visible by a block count and pidx / pmask by ballots and popcount
    prefixes equal the twin's on random masks, at MAXP 1 and 2, with no
    slot or every slot partial, over one to four warps of slots;
(c) the copy-CTA rule;
and the plain version against the TPU kernel at D = 373 (640x480, MF 60)
and at MAXP 2 (interpret mode).
"""

from __future__ import annotations

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from scenelib2_tpu.kernels.pallas_predict_measure import pallas_predict_measure
from scenelib2_torch.config import Params
from scenelib2_torch.eval.synthetic import HIRES_PARAMS
from scenelib2_torch.kernels import predict_measure as k1
from scenelib2_torch.kernels.measure import O_SCORE, O_VIS, MeasureConsts
from scenelib2_torch.kernels.predict_measure import CAM_DIM, bytes_and_flops, copy_ctas, predict_measure_plain

CU = os.path.join(os.path.dirname(k1.__file__), "csrc", "predict_measure.cu")
# K1 against the TPU kernel: per output row, |a - b| <= 1e-4 x the row's
# largest |entry| (x', P': of the matrix's), as tests/test_torch_kernels.py;
# decisions exactly
K1_TOL = 1e-4


def _cu_define(name: str) -> int:
    with open(CU) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read()).group(1))


THREADS = _cu_define("K1_THREADS")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- mirrors of the kernel's steps

CAMERA_BLOCK, CAMERA_ROW, CAMERA_COL, FEATURE = 0, 1, 2, 3


def unit_map(D: int, n_copy: int, vec: bool):
    """copy_units over every copy CTA: (writes [D*D] count of writes per
    element, writer [D*D] the CTA, kind [D*D], n_float4 units copied whole).
    CTA 0's camera block is added as the kernel's CTA 0 writes it."""
    N = D * D
    n_units = (N + 3) // 4
    per = -(-n_units // n_copy)
    writes = np.zeros(N, np.int64)
    writer = np.full(N, -1, np.int64)
    kind = np.full(N, -1, np.int64)
    n_vec = 0
    for cta in range(1, n_copy + 1):
        q0, q1 = (cta - 1) * per, min(cta * per, n_units)
        for t in range(THREADS):
            for q in range(q0 + t, q1, THREADS):
                e0 = 4 * q
                i, j = divmod(e0, D)
                if vec and i >= CAM_DIM and j >= CAM_DIM and j + 3 < D and e0 + 3 < N:
                    writes[e0 : e0 + 4] += 1
                    writer[e0 : e0 + 4] = cta
                    kind[e0 : e0 + 4] = FEATURE
                    n_vec += 1
                    continue
                for e in range(e0, min(e0 + 4, N)):
                    k = (FEATURE if i >= CAM_DIM and j >= CAM_DIM else CAMERA_ROW if i < CAM_DIM and j >= CAM_DIM
                         else CAMERA_COL if i >= CAM_DIM else None)
                    if k is not None:
                        writes[e] += 1
                        writer[e] = cta
                        kind[e] = k
                    j += 1
                    if j == D:
                        i, j = i + 1, 0
    cam = (np.arange(CAM_DIM)[:, None] * D + np.arange(CAM_DIM)[None, :]).ravel()
    writes[cam] += 1
    writer[cam] = 0
    kind[cam] = CAMERA_BLOCK
    return writes, writer, kind, n_vec


def assemble(D: int, kind, P, Po_twin):
    """P' through the map: the camera block Pc, a camera row (F P)[i, j],
    a camera column (F P)[j, i], the feature block P."""
    e = np.arange(D * D)
    i, j = e // D, e % D
    top = Po_twin[:CAM_DIM, :]                      # the twin's F P rows (and Pc at [:13, :13])
    out = np.empty(D * D, np.float32)
    m = kind == CAMERA_BLOCK
    out[m] = Po_twin.ravel()[e[m]]
    m = kind == CAMERA_ROW
    out[m] = top[i[m], j[m]]
    m = kind == CAMERA_COL
    out[m] = top[j[m], i[m]]
    m = kind == FEATURE
    out[m] = P.ravel()[e[m]]
    return out.reshape(D, D)


def ballot_tail(full, part, vis_flag, MF: int, maxp: int):
    """CTA 0's tail: n_visible as a block count of (full & vis == 0), and
    pidx / pmask from a ballot a warp of the partial flags, the warps'
    counts and each lane's popcount below it."""
    lanes = np.arange(THREADS)
    part_t = np.zeros(THREADS, bool)
    part_t[:MF] = part
    vis_t = np.zeros(THREADS, bool)
    vis_t[:MF] = full & (vis_flag == 0.0)
    nv = int(vis_t.sum())
    bal = [int(sum(1 << b for b in range(32) if part_t[32 * w + b])) for w in range(THREADS // 32)]
    wpart = [bin(b).count("1") for b in bal]
    pidx = np.full(maxp, -1, np.int64)
    pmask = np.zeros(maxp, bool)
    for tid in lanes[:MF]:
        warp, lane = divmod(int(tid), 32)
        below = bin(bal[warp] & ((1 << lane) - 1)).count("1")
        total = 0
        for w in range(-(-MF // 32)):
            below += wpart[w] if w < warp else 0
            total += wpart[w]
        pos = below if part_t[tid] else total + (tid - below)
        if pos < maxp:
            assert pidx[pos] == -1, "two lanes at one position"
            pidx[pos] = tid
            pmask[pos] = part_t[tid]
    return nv, pidx, pmask


# ---------------------------------------------------------------- scenes


def _scene(rng, MF: int, nan_lane: bool = False, part_frac: float = 0.2):
    D = 13 + 6 * MF
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
    partial = rng.uniform(size=MF) < part_frac
    if nan_lane:
        # a visible slot whose point covariance overflows S to inf - inf: a
        # NaN score, ranked last. 1e38 (not test_torch_kernels.py's 1e36):
        # at 640x480's focal length 1e36 x |Hy|^2 sits at f32's overflow
        # edge, where an ulp of Hy (XLA's CPU sqrt) decides inf or finite
        o = 13 + 6 * 3
        P[o, o], P[o + 1, o + 1] = 1e38, -1e38
        act[3], partial[3] = True, False
    return (x.astype(np.float32), P.astype(np.float32), xpo.astype(np.float32), act & ~partial, act & partial)


def _twin(scene, p: Params, maxp: int):
    x, P, xpo, af, ap = scene
    out = predict_measure_plain(torch.tensor(x), torch.tensor(P), torch.tensor(xpo), torch.tensor(af),
                                torch.tensor(ap), nsel=p.n_features_to_select, maxp=maxp, dt=p.delta_t,
                                sd_a=p.sd_a, sd_alpha=p.sd_alpha, consts=MeasureConsts.from_params(p))
    return [t.numpy() for t in out]


# ---------------------------------------------------------------- (a) the flat map


@pytest.mark.parametrize("D", [19, 109, 373, 379])
def test_unit_map_writes_each_element_once(D):
    counts = {copy_ctas(D, 132), copy_ctas(D, 16), 1, 7, 131}
    for n_copy in sorted(counts):
        for vec in (True, False):
            writes, writer, kind, n_vec = unit_map(D, n_copy, vec)
            assert (writes == 1).all(), (D, n_copy, vec)
            assert (writer >= 0).all() and writer.max() <= n_copy
            i, j = np.divmod(np.arange(D * D), D)
            want_kind = np.where((i < CAM_DIM) & (j < CAM_DIM), CAMERA_BLOCK,
                                 np.where(i < CAM_DIM, CAMERA_ROW, np.where(j < CAM_DIM, CAMERA_COL, FEATURE)))
            np.testing.assert_array_equal(kind, want_kind)
            assert n_vec == 0 if not vec else n_vec > 0 or D < 20
            if vec and D >= 109:
                # most of P' goes as whole 16-byte units
                assert 4 * n_vec > 0.8 * (D - CAM_DIM) ** 2


@pytest.mark.parametrize("MF", [1, 16, 60, 61])
def test_unit_map_assembles_the_twins_p(MF):
    D = 13 + 6 * MF
    p = Params(**HIRES_PARAMS) if MF >= 60 else Params()
    scene = _scene(np.random.default_rng(MF), MF)
    Po = _twin(scene, p, 1)[3]
    for vec in (True, False):
        kind = unit_map(D, copy_ctas(D, 132), vec)[2]
        got = assemble(D, kind, scene[1], Po)
        np.testing.assert_array_equal(got.view(np.uint32), Po.view(np.uint32))


# ---------------------------------------------------------------- (b) the ballot tail


@pytest.mark.parametrize("MF", [1, 16, 40, 60, 128])
@settings(max_examples=10, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(seed=st.integers(0, 2**31 - 1), maxp=st.sampled_from([1, 2]),
       part=st.sampled_from(["none", "all", "some", "one"]))
def test_ballot_tail_equals_twin(MF, seed, maxp, part):
    rng = np.random.default_rng(seed)
    frac = {"none": 0.0, "all": 1.0, "some": 0.3, "one": 0.0}[part]
    x, P, xpo, af, ap = _scene(rng, MF, part_frac=frac)
    if part == "all":
        af[:] = False
        ap[:] = True
    if part == "one":
        ap[:] = False
        ap[rng.integers(MF)] = True
    maxp = min(maxp, MF)
    p = Params(**HIRES_PARAMS) if MF >= 60 else Params()
    meas, _s, _x, _P, _i, _sc, n_vis, pidx, pmask = _twin((x, P, xpo, af, ap), p, maxp)
    nv, gidx, gmask = ballot_tail(af, ap, meas[O_VIS], MF, maxp)
    assert nv == int(n_vis)
    np.testing.assert_array_equal(gidx, pidx)
    np.testing.assert_array_equal(gmask, pmask)


# ---------------------------------------------------------------- (c) the rule, the bound


def test_copy_cta_rule():
    assert k1.THREADS == THREADS
    for D in (19, 109, 373, 781):
        for n_sms in (8, 132):
            n = copy_ctas(D, n_sms)
            assert 1 <= n <= max(1, n_sms - 1)
            units = (D * D + 3) // 4
            assert n == 1 or n == n_sms - 1 or (n - 1) * THREADS * k1.UNITS_PER_THREAD < units
    assert (copy_ctas(109, 132), copy_ctas(373, 132)) == (6, 68)


def test_bound_reads_and_writes_p_once():
    for MF in (16, 60):
        D = 13 + 6 * MF
        nbytes, _ops = bytes_and_flops(D, MF, 10)
        assert 8 * D * D < nbytes < 8 * D * D + 4096 + 300 * MF


# ---------------------------------------------------------------- the plain version against the TPU kernel


def _rowwise_close(got, want, tol, what):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want), err_msg=what)
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin], err_msg=what)
    scale = np.where(fin, np.abs(want), 0.0).max(axis=-1, keepdims=True)
    err = np.abs(np.where(fin, got, 0.0) - np.where(fin, want, 0.0))
    assert (err <= tol * np.maximum(scale, 1e-30)).all(), (what, float((err / np.maximum(scale, 1e-30)).max()))


@pytest.mark.parametrize("case", ["hires", "hires_nan_lane", "hires_maxp2", "std_maxp2"])
def test_plain_matches_pallas(case):
    hires = case.startswith("hires")
    p = Params(**HIRES_PARAMS) if hires else Params()
    MF = p.max_features
    maxp = 2 if case.endswith("maxp2") else 1
    rng = np.random.default_rng(["hires", "hires_nan_lane", "hires_maxp2", "std_maxp2"].index(case) + 91)
    x, P, xpo, af, ap = _scene(rng, MF, nan_lane=case == "hires_nan_lane", part_frac=0.2)
    want = pallas_predict_measure(
        jnp.asarray(x), jnp.asarray(P), jnp.asarray(xpo), jnp.asarray(af), jnp.asarray(ap),
        nsel=p.n_features_to_select, maxp=maxp, dt=p.delta_t, sd_a=p.sd_a, sd_alpha=p.sd_alpha,
        cam_static=(p.cam_fku, p.cam_fkv, p.cam_u0, p.cam_v0, p.cam_kd1), sd0=p.cam_sd,
        image_shape=(p.cam_height, p.cam_width), boundary=p.image_search_boundary,
        max_length_ratio=p.max_length_ratio, max_angle_difference=p.max_angle_difference,
        interpret=True,
    )
    meas, sel, xo, Po, top_idx, top_score, n_vis, pidx, pmask = _twin((x, P, xpo, af, ap), p, maxp)
    wmeas, wsel, wx, wP, widx, wscore, wnvis, wpidx, wpmask = (np.asarray(t) for t in want)
    assert int(n_vis) == int(wnvis) > 0
    np.testing.assert_array_equal(pidx, wpidx)
    np.testing.assert_array_equal(pmask, wpmask)
    nsel = p.n_features_to_select
    sel_mask = (np.arange(nsel) < n_vis) & (top_score > np.float32(-3e38))
    np.testing.assert_array_equal(sel_mask, (np.arange(nsel) < wnvis) & (wscore > np.float32(-3e38)))
    np.testing.assert_array_equal(top_idx[sel_mask], widx[sel_mask])
    if case == "hires_nan_lane":
        assert 3 not in top_idx[sel_mask] and np.isnan(meas[O_SCORE, 3])
    np.testing.assert_array_equal(Po[13:, 13:], P[13:, 13:])
    _rowwise_close(xo[None], wx[None], K1_TOL, "x'")
    _rowwise_close(Po.ravel()[None], wP.ravel()[None], K1_TOL, "P'")
    _rowwise_close(meas, wmeas, K1_TOL, "meas")
    _rowwise_close(sel, wsel, K1_TOL, "sel")
