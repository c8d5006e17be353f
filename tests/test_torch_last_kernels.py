"""The plain versions of K10b, K15 and K16, the three TPU kernels that no
step route runs, against the JAX Pallas kernels they port (interpret mode,
in this process), and against the kernels already ported that share their
work.

K10b (kernels/particle.py::particle_predict_kform) against
pallas_particle.py::pallas_particle_predict on the inputs of
tests/test_pallas_search.py::test_pallas_particle_predict_matches_xla (a
random camera, ray and 13 x 13 covariance; zeroed, K0, Ksym and K2 from the
JAX package's models.part_zeroedyi and N C N' products) at 64, 100 and 200
particles, and on degenerate depths (lambda 0 and negative: the ray behind
the camera). Rows within 1e-4 of each quantity's largest entry (XLA's CPU
f32 sqrt is off by an ulp at times, as for K10); the half-extents (integers)
and the non-finite positions exactly. On the geometry that K10's prologue
computes it writes K10's rows bit for bit.

K15 (kernels/ekf_update.py::joint_update_dense) against
pallas_ekf.py::pallas_joint_update_norm on the problem of
tests/test_pallas_ekf.py (D = 37 and D = 109, deleted slots), with
any_succ false, and with a NaN in a deleted slot: x' and P' within
K3_TOL = 1e-5 of the largest |entry| (the chip check's form; XLA's dots sum
in their own order), the deleted dimensions exactly zero, P' exactly
symmetric where it is finite, the NaN positions equal (the TPU kernel's
transpose, a product by the identity, spreads a NaN along its row). On H, nu, R assembled as the JAX step's
XLA branch assembles them (ekf_update.dense_inputs) it equals K3 on the
same selection bit for bit.

K16 (kernels/multi_ellipse.py::multi_ellipse_search) against
pallas_search.py::pallas_multi_ellipse_search on the inputs of
tests/test_pallas_search.py::test_pallas_particle_search_matches_dense
(two slots, 24 particles, centres around and beyond the image) and on
degenerate particles (centres far off the frame, a NaN centre, a NaN S^-1,
an S^-1 with a - b^2 / c < 0, no admitted cell, dead particles, a planted
tie, a NaN in the map): found, u, v and overflow exactly. On a captured
step of the SCENELIB2_BATCH_SB=0 batch route it decides as K13: found and
overflow equal, (u, v) equal for every live particle (K13 gives a dead
particle no key; K16 searches it).
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.kernels.pallas_ekf import pallas_joint_update_norm
from scenelib2_tpu.kernels.pallas_particle import pallas_particle_predict
from scenelib2_tpu.kernels.pallas_search import pallas_multi_ellipse_search
from scenelib2_torch.config import Params
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.kernels import correlate
from scenelib2_torch.kernels.ekf_update import (
    UpdateConsts,
    dense_inputs,
    joint_update_dense,
    joint_update_dense_plain,
    joint_update_plain,
    keep_of_kill,
)
from scenelib2_torch.kernels.measure import NOUT
from scenelib2_torch.kernels.multi_ellipse import multi_ellipse_search, multi_ellipse_search_plain
from scenelib2_torch.kernels.particle import (
    ParticleConsts,
    geometry_prologue,
    kform_rows_plain,
    particle_predict_kform,
    particle_predict_kform_plain,
    particle_predict_plain,
)
from scenelib2_torch.kernels.particle_search import particle_search_plain
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from tests.test_pallas_ekf import _problem

P_STD = dataclasses.replace(Params(), max_features=16)
ROW_TOL = 1e-4
K3_TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t32(a):
    return torch.tensor(np.asarray(a), dtype=torch.float32)


# ---------------------------------------------------------------------- K10b


def _kform_problem(seed, NP, lam=None):
    """The inputs of the JAX package's K10b test: (zeroed [1, 6], K0, Ksym,
    K2 [1, 3, 3], lam [1, NP]) as f32 numpy, from its own geometry."""
    from scenelib2_tpu.core import models

    rng = np.random.default_rng(seed)
    f32 = jnp.float32
    xp = np.zeros(7)
    xp[3:7] = rng.normal(size=4)
    xp[3:7] /= np.linalg.norm(xp[3:7])
    xp[:3] = rng.normal(0, 0.1, 3)
    y6 = np.concatenate([rng.normal(0, 0.1, 3), rng.normal(size=3)])
    y6[3:] /= np.linalg.norm(y6[3:])
    if y6[5] < 0.3:
        y6[3:] = [0.1, 0.1, 0.99]
        y6[3:] /= np.linalg.norm(y6[3:])
    A = rng.normal(size=(13, 13))
    C13 = A @ A.T / 80 + np.eye(13) * 1e-4
    zeroed, dzx, dzy = models.part_zeroedyi(jnp.asarray(y6, f32), jnp.asarray(xp, f32))
    C = jnp.asarray(C13, f32)
    N1 = jnp.concatenate([dzx[0:3], dzy[0:3]], 1)
    N2 = jnp.concatenate([dzx[3:6], dzy[3:6]], 1)
    CN1, CN2 = C @ N1.T, C @ N2.T
    K0, K12, K2 = N1 @ CN1, N1 @ CN2, N2 @ CN2
    lam = np.linspace(0.5, 5.0, NP) if lam is None else np.asarray(lam)
    return tuple(np.asarray(a, np.float32)[None] for a in (zeroed, K0, K12 + K12.T, K2, lam))


def _cam():
    from scenelib2_tpu.core.camera import CameraParams
    from scenelib2_tpu.config import Params as JParams

    c = CameraParams.from_params(JParams())
    return dict(fku=c.fku, fkv=c.fkv, u0c=c.u0, v0c=c.v0, kd1=c.kd1, sd0=c.sd, no_sigma=3.0)


@pytest.mark.parametrize("case", ["np64", "np100", "np200", "degenerate"])
def test_k10b_plain_matches_pallas(case):
    if case == "degenerate":
        inputs = _kform_problem(5, 0, lam=[-1.0, 0.0, 1e-30, 0.5, 2.0, 1e30])
    else:
        NP = int(case[2:])
        inputs = _kform_problem(NP, NP)
    kw = _cam()
    got = [t.numpy() for t in particle_predict_kform(*(torch.from_numpy(a) for a in inputs), **kw)]
    want = [np.asarray(w) for w in pallas_particle_predict(*(jnp.asarray(a) for a in inputs), interpret=True,
                                                           **kw)]
    NP = inputs[4].shape[1]
    for name, g, w in zip(("hpi", "sinv", "dets", "hw", "hh"), got, want):
        assert g.shape == w.shape and g.dtype == np.float32, name
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin, err_msg=name)
        np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=name)       # same infinities, NaN as NaN
        if name in ("hw", "hh"):
            np.testing.assert_array_equal(g[fin], w[fin], err_msg=name)
        else:
            scale = max(float(np.abs(w[fin]).max()), 1e-30) if fin.any() else 1.0
            assert (np.abs(g[fin] - w[fin]) <= ROW_TOL * scale).all(), name
    # S^-1 assembled symmetric from its off-diagonal row
    assert np.array_equal(got[1][..., 0, 1], got[1][..., 1, 0], equal_nan=True)
    if case == "np200":
        assert np.isfinite(want[0]).all() and NP == 200
    if case == "degenerate":
        assert not all(np.isfinite(w).all() for w in want)


def test_k10b_on_k10s_prologue_writes_k10s_rows():
    """K10b's tail given the geometry K10 computes from the state rows is
    K10: the same rows bit for bit, padding lanes included."""
    rng = np.random.default_rng(3)
    c = ParticleConsts.from_params(P_STD)
    for NP in (100, 200):
        q = np.array([1.0, *rng.normal(0, 0.02, 3)])
        d = 13
        M = rng.normal(size=(d, d))
        C = np.sqrt(1e-4) * (np.eye(d) + 0.5 * M @ M.T / d) * np.sqrt(1e-4)
        shared = t32(np.concatenate([rng.normal(0, 0.01, 3), q / np.linalg.norm(q), C[:7, :7].ravel()]))[None]
        h = np.array([*rng.normal(0, 0.06, 2), 1.0])
        slot = t32(np.concatenate([rng.normal(0, 0.1, 3), h / np.linalg.norm(h), C[:7, 7:].ravel(),
                                   C[7:, 7:].ravel()]))[None, None]
        lam = t32(np.linspace(0.5, 5.0, NP))[None, None]
        k10 = particle_predict_plain(shared, slot, lam, c)
        zr, zh, K0, Ks, K2 = geometry_prologue(shared[:, None, :], slot)
        rows = kform_rows_plain(torch.cat([zr, zh], -1)[0], K0[0], Ks[0], K2[0], lam[0], c)
        assert rows.shape == k10[0].shape
        assert torch.equal(rows.nan_to_num(7.0), k10[0].nan_to_num(7.0))


def test_k10b_wrapper_takes_the_plain_version_for_cpu_tensors():
    inputs = [torch.from_numpy(a) for a in _kform_problem(11, 40)]
    kw = _cam()
    for g, w in zip(particle_predict_kform(*inputs, **kw), particle_predict_kform_plain(*inputs, **kw)):
        assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))


# ---------------------------------------------------------------------- K15


def _k15_case(case):
    rng = np.random.default_rng({"mf4": 1, "mf16": 2, "no_success": 3, "nan_deleted": 4,
                                 "nan_deleted_no_success": 5}[case])
    MF, NSEL = (16, 10) if case == "mf16" else (4, 3)
    x, P, H, nu, R, keep = _problem(rng, MF=MF, NSEL=NSEL, n_bad=1)
    if case.startswith("nan"):
        off = 13 + 6 * (MF - 1)                     # the deleted slot
        P[off, off + 1] = P[off + 1, off] = np.nan
        x[off] = np.nan
    return x, P, H, nu, R, not case.endswith("no_success"), keep


@pytest.mark.parametrize("case", ["mf4", "mf16", "no_success", "nan_deleted", "nan_deleted_no_success"])
def test_k15_plain_matches_pallas(case):
    x, P, H, nu, R, any_succ, keep = _k15_case(case)
    got = [g.numpy() for g in joint_update_dense_plain(
        *(t32(a) for a in (x, P, H, nu, R)), torch.tensor(any_succ), torch.tensor(keep))]
    want = [np.asarray(w) for w in pallas_joint_update_norm(
        *(jnp.asarray(a, jnp.float32) for a in (x, P, H, nu, R)), jnp.asarray(any_succ), jnp.asarray(keep),
        interpret=True)]
    for name, g, w in zip(("x'", "P'"), got, want):
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=name)
        fin = ~np.isnan(w)
        scale = float(np.abs(w[fin]).max()) if fin.any() else 1.0
        assert (np.abs(g[fin] - w[fin]) <= K3_TOL * scale).all(), (name, float(np.abs(g[fin] - w[fin]).max()))
    Pg = got[1]
    if not case.startswith("nan"):
        assert np.array_equal(Pg, Pg.T)
        assert (Pg[~keep] == 0.0).all() and (got[0][~keep] == 0.0).all()
    if case == "nan_deleted_no_success":
        # the keep mask multiplies, so the deleted slot's NaN stays; the TPU
        # kernel's P' = P I spreads it along its rows, the rest is the
        # symmetrized prior
        off = 13 + 6 * 3
        rows = np.zeros_like(Pg, dtype=bool)
        rows[off : off + 2] = True
        np.testing.assert_array_equal(np.isnan(Pg), rows)
        assert np.isnan(got[0]).sum() == 1
        ok = ~np.isnan(Pg)
        Pp = np.where(keep[:, None] & keep[None, :], P, 0.0).astype(np.float32)
        np.testing.assert_allclose(Pg[ok], ((Pp * 0.5) + (Pp.T * 0.5))[ok], rtol=1e-6, atol=0)
    if case == "no_success":
        np.testing.assert_array_equal(got[0][keep], x.astype(np.float32)[keep])


def _k3_scene(seed, D=109, MF=16, NSEL=10):
    """K3's inputs on a random selection: the bookkeeping kills slot 0."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(D, D))
    P = (A @ A.T / D * 1e-3 + np.eye(D) * 1e-4).astype(np.float32)
    x = (rng.normal(size=D) * 0.1).astype(np.float32)
    x[3:7] = [0.9, 0.1, -0.2, 0.3]
    sel = (rng.normal(size=(NOUT, NSEL)) * 0.5).astype(np.float32)
    sel[22] = rng.uniform(1.0, 2.0, NSEL)
    top = rng.choice(MF, NSEL, replace=False).astype(np.int32)
    succ = rng.uniform(size=NSEL) > 0.3
    attempts = np.full(MF, 20, np.int32)
    successes = np.where(np.arange(MF) == top[0], 0, 4).astype(np.int32)
    arrs = (x, P, sel, rng.normal(size=(NSEL, 2)).astype(np.float32), succ, (13 + 6 * top).astype(np.int32),
            attempts, successes, np.zeros(MF, bool), np.ones(MF, bool), np.arange(MF, dtype=np.int32),
            np.ones(NSEL, bool), top)
    return tuple(torch.tensor(a) for a in arrs)


@pytest.mark.parametrize("seed", [0, 1])
def test_k15_on_the_xla_branch_assembly_equals_k3(seed):
    """H, nu, R assembled as the JAX step's XLA branch does from K1's
    selected columns, and keep from K3's kill: K15 equals K3 (the dense sums
    add exact zeros where K3 skips H's zeros)."""
    a = _k3_scene(seed)
    c = UpdateConsts.from_params(P_STD)
    k3 = joint_update_plain(*a, c)
    assert bool(k3[5].any())                        # a slot dies: the keep mask is live
    H, nu, R = dense_inputs(a[0].shape[0], *a[2:6])
    assert H.shape == (20, 109) and bool((H[:, 13:] != 0).sum(1).le(3).all())
    x15, P15 = joint_update_dense_plain(a[0], a[1], H, nu, R, a[4].any(), keep_of_kill(k3[5]))
    for g, w in ((x15, k3[0]), (P15, k3[1])):
        assert float((g - w).abs().max()) <= K3_TOL * float(w.abs().max())
    assert torch.equal(x15, k3[0]) and torch.equal(P15, k3[1])


def test_k15_wrapper_takes_the_plain_version_for_cpu_tensors():
    x, P, H, nu, R, any_succ, keep = _k15_case("mf4")
    args = (*(t32(a) for a in (x, P, H, nu, R)), torch.tensor(any_succ), torch.tensor(keep))
    for g, w in zip(joint_update_dense(*args), joint_update_dense_plain(*args)):
        assert torch.equal(g, w)


# ---------------------------------------------------------------------- K16

K16_H, K16_W, K16_R = 120, 160, 16


def _k16_case(case):
    """The JAX test's maps and clouds; "degenerate" adds the degenerate
    particles, "tie" a planted three-way tie."""
    rng = np.random.default_rng({"jax_suite": 42, "degenerate": 43, "tie": 44}[case])
    Hh, W = K16_H, K16_W
    F, P = 2, 24
    maps = rng.uniform(0.0, 2.0, size=(F, Hh, W)).astype(np.float32)
    for f in range(F):
        for _ in range(30):
            maps[f, rng.integers(0, Hh), rng.integers(0, W)] = rng.uniform(0, 0.3)
    centres = np.stack([np.stack([rng.uniform(-5, W + 5, size=P), rng.uniform(-5, Hh + 5, size=P)], axis=1)
                        for _ in range(F)])
    sinvs = np.zeros((F, P, 2, 2))
    for f in range(F):
        for p in range(P):
            a = rng.uniform(0.02, 0.4)
            c = rng.uniform(0.02, 0.4)
            b = rng.uniform(-0.5, 0.5) * np.sqrt(a * c)
            sinvs[f, p] = [[a, b], [b, c]]
    alive = rng.uniform(size=(F, P)) > 0.2
    if case == "degenerate":
        centres[0, 0] = [-1e12, 5.0]
        centres[0, 1] = [np.nan, 50.0]
        centres[0, 2] = [3e9, 3e9]
        centres[0, 3] = [W + 40.0, -30.0]
        sinvs[0, 4] = np.nan
        sinvs[0, 5] = [[1.0, 2.0], [2.0, 1.0]]           # a - b^2 / c < 0: no half-extent
        sinvs[0, 6] = [[400.0, 0.0], [0.0, 400.0]]       # half-extents 0: only the centre cell
        centres[0, 6] = [100.5, 100.5]
        sinvs[0, 7] = [[1e-6, 0.0], [0.0, 1e-6]]         # beyond the window: overflow
        centres[0, 7] = [80.0, 60.0]
        alive[0, 7:10] = [True, False, False]
        maps[1, 60, 60] = np.nan                         # a NaN score under particle 0 of slot 1
        centres[1, 0] = [60.0, 61.0]
        sinvs[1, 0] = [[0.05, 0.0], [0.0, 0.05]]
        alive[1, 0] = True
    if case == "tie":
        sinvs[1, :] = [[0.05, 0.0], [0.0, 0.05]]
        centres[1, :] = [80.2, 60.7]
        maps[1, 58, 81] = maps[1, 61, 79] = maps[1, 60, 82] = -0.5
    return (maps, centres.astype(np.float32), sinvs.astype(np.float32), alive)


@pytest.mark.parametrize("case", ["jax_suite", "degenerate", "tie"])
def test_k16_plain_matches_pallas(case):
    maps, centres, sinvs, alive = _k16_case(case)
    got = [g.numpy() for g in multi_ellipse_search_plain(t32(maps), t32(centres), t32(sinvs),
                                                         torch.tensor(alive), win_radius=K16_R)]
    want = [np.asarray(w) for w in pallas_multi_ellipse_search(
        jnp.asarray(maps), jnp.asarray(centres), jnp.asarray(sinvs), jnp.asarray(alive), win_radius=K16_R,
        interpret=True)]
    for name, g, w in zip(("found", "u", "v", "over"), got, want):
        np.testing.assert_array_equal(g, w, err_msg=f"{case}: {name}")
    assert got[1].dtype == np.int32 and got[0].any()
    if case == "degenerate":
        # a centre beyond the frame (no admitted cell), a NaN S^-1, no half-extent: key -1
        assert (got[1][0, [3, 4, 5]] == -1).all() and (got[2][0, [3, 4, 5]] == K16_H - 1).all()
        assert (got[1][0, 6], got[2][0, 6]) == (100, 100)
        assert got[3][0, 7] and not got[3][0, 8]         # overflow only where alive
        assert not got[0][1, 0] and got[1][1, 0] == -1   # the NaN score: no key
    if case == "tie":
        assert (got[1][1] == 82).all() and (got[2][1] == 60).all()   # the largest u*H + v of the tie


def test_k16_equals_the_dense_search_on_the_jax_suite():
    """As the JAX test holds the TPU kernel to multi_ellipse_search_dense."""
    maps, centres, sinvs, alive = _k16_case("jax_suite")
    got = multi_ellipse_search_plain(t32(maps), t32(centres), t32(sinvs), torch.tensor(alive), win_radius=K16_R)
    want = correlate.multi_ellipse_search_dense(t32(maps)[None], t32(centres)[None], t32(sinvs)[None],
                                                torch.tensor(alive)[None], win_radius=K16_R)
    for i, name in enumerate(("found", "u", "v", "over")):
        g, w = got[i], want[i][0]
        if name in ("u", "v"):
            g, w = g[want[0][0]], w[want[0][0]]
        assert torch.equal(g, w), name


@pytest.fixture(scope="module")
def sb0_steps(tmp_path_factory):
    """The K13 calls of the port's CPU replay of lanes 0 and 32 on the
    SCENELIB2_BATCH_SB=0 route, 22 frames."""
    import scenelib2_torch.runtime.step as step_mod

    params, states, frames = make_lanes(str(tmp_path_factory.mktemp("lanes")), n_frames=24, device="cpu",
                                        dtype=torch.float32, lanes=(0, 32))
    calls = []
    orig = step_mod.particle_search

    def keep(*a, **k):
        calls.append(a)
        return orig(*a, **k)

    step_mod.particle_search = keep
    try:
        run_batch(make_batched_step(params, device="cpu", batch_sb=False), states, frames, True, params)
    finally:
        step_mod.particle_search = orig
    return calls


def test_k16_decides_as_k13_on_captured_sb0_steps(sb0_steps):
    live = 0
    for maps, h, sinv, alive, c in sb0_steps:
        Bn, Fn, H, W = maps.shape
        k13 = particle_search_plain(maps, h, sinv, alive, c)
        k16 = multi_ellipse_search(maps.reshape(-1, H, W), h.reshape(Bn * Fn, -1, 2),
                                   sinv.reshape(Bn * Fn, -1, 2, 2), alive.reshape(Bn * Fn, -1),
                                   win_radius=c.win_radius, no_sigma=c.no_sigma, corr_thresh2=c.corr_thresh2)
        k16 = [t.reshape(alive.shape) for t in k16]
        assert torch.equal(k16[0], k13[0]) and torch.equal(k16[3], k13[3])
        assert torch.equal(k16[1][alive], k13[1][alive]) and torch.equal(k16[2][alive], k13[2][alive])
        live += int(alive.sum())
    assert live > 0 and any(bool(a[3].any()) and bool(k.any()) for a, k in
                            ((a, particle_search_plain(*a)[0]) for a in sb0_steps))
