"""The mapping half of the port's core and state against the JAX package.

  - the ray model (core/models.part_*), unproject and its Jacobian, the
    vector-normalisation Jacobian, function by function, in f64 and f32
    (tolerances as tests/test_torch_core.py: 1e-12 and 1e-5 of the largest
    entry of each output);
  - the tensor drand48 (rng.drand48_step / drand48_many) against
    scenelib2_tpu.rng and the host stream, exactly;
  - the initial depth grid (state.lambda_grid), bit for bit;
  - the in-step state surgery (state.add_partial_feature, convert_feature):
    against the JAX package (floats to 1e-12 in f64 and 1e-5 in f32 of the
    largest entry; integers, masks and patches exactly), disabled calls
    leave the state bit-unchanged, an insert at full capacity is a no-op;
  - the property fuzz of tests/test_state_fuzz.py on the port's state, in
    lockstep with the JAX package.
"""

from __future__ import annotations

import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu import rng as jrng
from scenelib2_tpu.config import Params as JParams
from scenelib2_tpu.core import camera as jcam
from scenelib2_tpu.core import models as jmodels
from scenelib2_tpu.core import quaternion as jq
from scenelib2_tpu.runtime import state as jst
from scenelib2_torch import rng as trng
from scenelib2_torch.config import Params as TParams
from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.core import camera as tcam
from scenelib2_torch.core import models as tmodels
from scenelib2_torch.core import quaternion as tq
from scenelib2_torch.runtime import state as tst

TOL = {torch.float64: 1e-12, torch.float32: 1e-5}
JCAM = jcam.CameraParams.from_params(JParams())
TCAM = tcam.CameraParams.from_params(TParams())
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small tensor ops: intra-op threads only contend with the other test
    workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _near_unit(rng):
    v = rng.normal(size=4)
    return v / np.linalg.norm(v) * (1.0 + rng.uniform(-1e-3, 1e-3))


def _xp(rng):
    return np.concatenate([rng.normal(size=3) * 0.05, [1.0, 0.0, 0.0, 0.0] + rng.normal(size=4) * 0.02])


def _ray(rng):
    hh = rng.normal(size=3) * 0.2 + np.array([0.0, 0.0, 1.0])
    return np.concatenate([rng.normal(size=3) * 0.05, hh / np.linalg.norm(hh)])


def _pixel(rng):
    return np.array([rng.uniform(5, 315), rng.uniform(5, 235)])


# name -> (input builder, JAX function, torch function)
CASES = {
    "quat_conjugate": (lambda r: (_near_unit(r),), jq.quat_conjugate, tq.quat_conjugate),
    "dvnorm_by_dv": (lambda r: (r.normal(size=3),), jq.dvnorm_by_dv, tq.dvnorm_by_dv),
    "unproject": (lambda r: (_pixel(r),), lambda h: jcam.unproject(JCAM, h),
                  lambda h: tcam.unproject(TCAM, h)),
    "unproject_jacobian": (lambda r: (_pixel(r),), lambda h: jcam.unproject_jacobian(JCAM, h),
                           lambda h: tcam.unproject_jacobian(TCAM, h)),
    "part_init_ray": (lambda r: (_pixel(r), _xp(r)), lambda h, xp: jmodels.part_init_ray(JCAM, h, xp),
                      lambda h, xp: tmodels.part_init_ray(TCAM, h, xp)),
    "part_zeroedyi": (lambda r: (_ray(r), _xp(r)), jmodels.part_zeroedyi, tmodels.part_zeroedyi),
    "part_predict_measurement": (
        lambda r: (_ray(r), _xp(r), np.float64(r.uniform(0.5, 5.0))),
        lambda y, xp, lam: jmodels.part_predict_measurement(JCAM, y, xp, lam),
        lambda y, xp, lam: tmodels.part_predict_measurement(TCAM, y, xp, lam)),
    "part_convert_to_full": (lambda r: (_ray(r), np.float64(r.uniform(0.5, 5.0))),
                             jmodels.part_convert_to_full, tmodels.part_convert_to_full),
}


def _as_tuple(v):
    return tuple(v) if isinstance(v, (tuple, list)) else (v,)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_mapping_core_function_matches_jax(name, dtype):
    build, jfn, tfn = CASES[name]
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    for _trial in range(3):
        args = build(rng)
        want = _as_tuple(jfn(*(jnp.asarray(np.asarray(a, np.float64)) for a in args)))
        got = _as_tuple(tfn(*(torch.tensor(np.asarray(a, np.float64), dtype=dtype) for a in args)))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            g = g.double().numpy()
            w = np.asarray(w, np.float64)
            assert g.shape == w.shape, (name, g.shape, w.shape)
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g, w, rtol=TOL[dtype], atol=TOL[dtype] * scale, err_msg=name)


# ------------------------------------------------------------------ drand48


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_drand48_matches_jax_and_host_stream(seed):
    n = 10
    limbs = jrng.pack_state(jrng.srand48(seed))
    want_states, want_vals = jrng.drand48_many(jnp.asarray(limbs), n)
    got_states, got_vals = trng.drand48_many(torch.tensor(limbs.astype(np.int32)), n)
    assert got_states.dtype == torch.int32
    np.testing.assert_array_equal(got_states.numpy(), np.asarray(want_states).astype(np.int32))
    np.testing.assert_array_equal(got_vals.numpy(), np.asarray(want_vals))
    np.testing.assert_array_equal(got_vals.numpy(), jrng.host_drand48_sequence(seed, n))
    np.testing.assert_array_equal(trng.host_drand48_sequence(seed, n), jrng.host_drand48_sequence(seed, n))
    # one step at a time gives the same stream
    s = torch.tensor(limbs.astype(np.int32))
    for i in range(n):
        s, v = trng.drand48_step(s)
        np.testing.assert_array_equal(s.numpy(), got_states[i].numpy())
        assert float(v) == float(got_vals[i])
    assert trng.unpack_state(s.numpy()) == jrng.unpack_state(np.asarray(want_states[-1]))


@pytest.mark.parametrize("n_particles", [100, 37])
def test_lambda_grid_bit_equal(n_particles):
    want = jst.lambda_grid(JParams(n_particles=n_particles))
    got = tst.lambda_grid(TParams(n_particles=n_particles))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- state surgery

SMALL_J = JParams(max_features=4, n_particles=10)
SMALL_T = TParams(max_features=4, n_particles=10)
D_SMALL = SMALL_J.state_dim


def _jax_numpy(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_state_close(tstate, jstate, dtype, what=""):
    got = state_to_numpy(tstate)
    want = _jax_numpy(jstate)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape, (what, k)
        if np.issubdtype(w.dtype, np.floating):
            scale = max(float(np.abs(w).max()), 1e-30)
            np.testing.assert_allclose(g.astype(np.float64), w, rtol=0,
                                       atol=TOL[dtype] * scale, err_msg=f"{what} {k}")
        else:
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=f"{what} {k}")


def _assert_state_identical(a, b, what=""):
    for name, x, y in zip(a._fields, a, b):
        assert torch.equal(x, y), (what, name)


def _random_cam_state(rng):
    A = rng.normal(size=(13, 13)) * 0.05
    xv = rng.normal(size=13)
    xv[3:7] = [1.0, 0.0, 0.0, 0.0] + rng.normal(size=4) * 0.02
    return jst.init_state(SMALL_J, xv, A @ A.T + np.eye(13) * 1e-6)


def _both(js, dtype):
    return js, state_from_jax(_jax_numpy(js), CPU, dtype)


def _add_partial(js, ts, h, patch, enable, dtype):
    lam0_j = jnp.asarray(jst.lambda_grid(SMALL_J))
    lam0_t = torch.tensor(tst.lambda_grid(SMALL_T), dtype=dtype)
    js = jst.add_partial_feature(js, JCAM, jnp.asarray(h), jnp.asarray(patch), lam0_j,
                                 jnp.asarray(enable))
    ts = tst.add_partial_feature(ts, TCAM, torch.tensor(h, dtype=dtype), torch.tensor(patch),
                                 lam0_t, torch.tensor(enable))
    return js, ts


def _convert(js, ts, slot, mean, cov, enable, dtype):
    js = jst.convert_feature(js, jnp.int32(slot), jnp.float64(mean), jnp.float64(cov),
                             jnp.asarray(enable))
    ts = tst.convert_feature(ts, torch.tensor(slot, dtype=torch.int32), torch.tensor(mean, dtype=dtype),
                             torch.tensor(cov, dtype=dtype), torch.tensor(enable))
    return js, ts


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_add_partial_and_convert_match_jax(dtype):
    rng = np.random.default_rng(3)
    patch = rng.integers(0, 256, (11, 11), dtype=np.uint8)
    js, ts = _both(_random_cam_state(rng), dtype)
    js = js._replace(next_label=jnp.int32(5))
    ts = ts._replace(next_label=torch.tensor(5, dtype=torch.int32))
    for k in range(3):
        js, ts = _add_partial(js, ts, _pixel(rng), patch, True, dtype)
        _assert_state_close(ts, js, dtype, f"insert {k}")
    assert ts.active.tolist() == [True, True, True, False]
    assert not ts.full.any() and int(ts.next_label) == 8
    # a disabled insert and a disabled conversion are exact no-ops
    before = ts
    _js2, ts = _add_partial(js, ts, _pixel(rng), patch, False, dtype)
    _assert_state_identical(ts, before, "disabled insert")
    _js2, ts = _convert(js, ts, 1, 2.0, 0.01, False, dtype)
    _assert_state_identical(ts, before, "disabled convert")
    js, ts = _convert(js, ts, 1, 2.0, 0.01, True, dtype)
    _assert_state_close(ts, js, dtype, "convert")
    assert ts.full.tolist() == [False, True, False, False] and not ts.palive[1].any()
    off = tst.slot_offset(1)
    assert not ts.x[off + 3 : off + 6].any() and not ts.P[off + 3 : off + 6].any()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_insert_at_full_capacity_is_a_no_op(dtype):
    rng = np.random.default_rng(4)
    patch = rng.integers(0, 256, (11, 11), dtype=np.uint8)
    js, ts = _both(_random_cam_state(rng), dtype)
    for _ in range(4):
        js, ts = _add_partial(js, ts, _pixel(rng), patch, True, dtype)
    assert bool(ts.active.all())
    before = ts
    js, ts = _add_partial(js, ts, _pixel(rng), patch, True, dtype)
    _assert_state_identical(ts, before, "insert into a full map")
    _assert_state_close(ts, js, dtype, "insert into a full map")


def _check_invariants(s):
    """tests/test_state_fuzz.py::check_invariants on the port's state."""
    P = s.P.double().numpy()
    x = s.x.double().numpy()
    active, full = s.active.numpy(), s.full.numpy()
    palive, label = s.palive.numpy(), s.label.numpy()
    scaleP = max(1.0, float(np.abs(P).max()))
    np.testing.assert_allclose(P, P.T, rtol=0.0, atol=1e-13 * scaleP)
    w = np.linalg.eigvalsh((P + P.T) / 2.0)
    assert w[0] >= -1e-10 * max(1.0, float(w[-1]))
    dead = np.zeros(D_SMALL, bool)
    for i in range(SMALL_T.max_features):
        off = tst.slot_offset(i)
        if not active[i]:
            dead[off : off + 6] = True
        elif full[i]:
            dead[off + 3 : off + 6] = True
    assert np.abs(x[dead]).max(initial=0.0) == 0.0
    assert np.abs(P[dead, :]).max(initial=0.0) == 0.0
    assert np.abs(P[:, dead]).max(initial=0.0) == 0.0
    assert not np.any(full & ~active)
    assert not np.any(palive[full | ~active])
    assert np.all(label[~active] == -1)
    live = label[active]
    assert len(set(live.tolist())) == len(live)
    assert live.max(initial=-1) < int(s.next_label)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_surgery_fuzz_in_lockstep_with_jax(seed):
    """Random interleavings of insert / known insert / convert / delete (with
    slot reuse) on both packages' f64 states: the port keeps the reference's
    structural invariants and stays within 1e-12 of the JAX state."""
    rng = np.random.default_rng(seed)
    dtype = torch.float64
    js, ts = _both(_random_cam_state(rng), dtype)
    patch = rng.integers(0, 256, size=(11, 11), dtype=np.uint8)
    n_ops = {"add_partial": 0, "convert": 0}
    for step in range(40):
        active, full = ts.active.numpy(), ts.full.numpy()
        partial_slots = np.nonzero(active & ~full)[0]
        op = rng.choice(["add_partial", "add_known", "convert", "delete", "noop_add", "noop_convert"])
        if op == "add_partial":
            js, ts = _add_partial(js, ts, _pixel(rng), patch, True, dtype)
            n_ops[op] += 1
        elif op == "add_known" and not active.all():
            y = rng.normal(size=3)
            xpo = np.concatenate([rng.normal(size=3), [1, 0, 0, 0]])
            js = jst.add_known_feature(js, y, xpo, patch)
            ts = tst.add_known_feature(ts, y, xpo, patch)
        elif op == "convert" and len(partial_slots):
            slot = int(rng.choice(partial_slots))
            js, ts = _convert(js, ts, slot, rng.uniform(0.5, 5.0), rng.uniform(0.0, 0.1), True, dtype)
            n_ops[op] += 1
        elif op == "delete" and active.any():
            kill = (rng.random(SMALL_T.max_features) < 0.5) & active
            js = jst.delete_mask(js, jnp.asarray(kill))
            ts = tst.delete_mask(ts, torch.tensor(kill))
        elif op == "noop_add":
            before = ts
            js, ts = _add_partial(js, ts, np.array([100.0, 100.0]), patch, False, dtype)
            _assert_state_identical(ts, before, "noop_add")
        elif op == "noop_convert" and len(partial_slots):
            before = ts
            js, ts = _convert(js, ts, int(partial_slots[0]), 2.0, 0.01, False, dtype)
            _assert_state_identical(ts, before, "noop_convert")
        _check_invariants(ts)
        _assert_state_close(ts, js, dtype, f"step {step} ({op})")
    assert n_ops["add_partial"] > 0
