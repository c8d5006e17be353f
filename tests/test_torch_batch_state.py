"""The lane forms of the state surgery against the JAX package under vmap.

The batch step keeps B independent states stacked along a leading lane
dimension. add_partial_feature, convert_feature and delete_mask over lanes
are held against the JAX package's ``onehot=True`` forms under jax.vmap (the
forms its batch step runs), on seeded random states in f64, lanes whose gate
is on beside lanes whose gate is off: integers and flags exactly, floats
within 1e-12 of the largest entry (the products sum in another order), and
a lane with its gate off comes back bit for bit. Also: the per-lane random
streams of replicate_states, and stacked JAX states through state_from_jax.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.config import load_config as jload_config
from scenelib2_tpu.core.camera import CameraParams as JCameraParams
from scenelib2_tpu.parallel.mesh import replicate_states as jreplicate
from scenelib2_tpu.runtime import state as jst
from scenelib2_torch.config import load_config as tload_config
from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.core.camera import CameraParams
from scenelib2_torch.parallel.mesh import lane_state, replicate_states, stack_states
from scenelib2_torch.rng import Drand48, drand48_many, unpack_state
from scenelib2_torch.runtime import state as tst
from tests.test_torch_state import _jax_numpy, _random_jax_state

CPU = torch.device("cpu")
N_LANES = 5
FLOAT_TOL = 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def lanes(rng, data_dir):
    """N_LANES random JAX states stacked, the port's copy, and the config."""
    cfg = os.path.join(data_dir, "SceneLib2.cfg")
    js = [_random_jax_state(rng, cfg) for _ in range(N_LANES)]
    # slot 2 of every lane holds a ray; lane 1 has no free slot
    js = [s._replace(active=s.active.at[2].set(True), full=s.full.at[2].set(False)) for s in js]
    js[1] = js[1]._replace(active=jnp.ones_like(js[1].active))
    jb = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *js)
    tb = state_from_jax(_jax_numpy(jb), CPU, torch.float64)
    return jb, tb, cfg


def _assert_states_close(got: dict, want: dict, exact_lanes=()):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.kind == "f":
            scale = max(np.abs(want[k]).max(), 1e-300)
            assert np.abs(got[k] - want[k]).max() <= FLOAT_TOL * scale, k
        else:
            np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
        for b in exact_lanes:
            np.testing.assert_array_equal(got[k][b], want[k][b].astype(got[k].dtype), err_msg=(k, b))


def test_state_from_jax_takes_stacked_states(lanes):
    jb, tb, _cfg = lanes
    assert tst.has_lanes(tb) and tb.x.shape == (N_LANES, jb.x.shape[1])
    want = _jax_numpy(jb)
    got = state_to_numpy(tb)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # lane k of the stacked state is the conversion of JAX lane k, and stacking back is exact
    one = state_to_numpy(lane_state(tb, 3))
    for k in want:
        np.testing.assert_array_equal(one[k], want[k][3], err_msg=k)
    again = state_to_numpy(stack_states([lane_state(tb, b) for b in range(N_LANES)]))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)
    # an older stacked checkpoint without patch rows derives them per lane
    old = {k: v for k, v in want.items() if k != "patch_rows"}
    conv = state_from_jax(old, CPU, torch.float64)
    np.testing.assert_array_equal(
        conv.patch_rows[2, 4].numpy(), np.asarray(jst.patch_row(jnp.asarray(want["patches"][2, 4]))))


def test_add_partial_feature_over_lanes_matches_jax_onehot_vmap(rng, lanes):
    jb, tb, cfg = lanes
    jcam = JCameraParams.from_params(jload_config(cfg).params)
    tcam = CameraParams.from_params(tload_config(cfg).params)
    NP = jb.lam.shape[-1]
    h = rng.uniform([40, 40], [280, 200], (N_LANES, 2))
    patch = rng.integers(0, 256, (N_LANES, 11, 11)).astype(np.uint8)
    lam0 = np.linspace(0.5, 5.0, NP)
    enable = np.array([True, True, False, True, False])     # lane 1 is full: a no-op too
    want = jax.vmap(lambda s, hh, pp, en: jst.add_partial_feature(
        s, jcam, hh, pp, jnp.asarray(lam0), en, onehot=True))(
        jb, jnp.asarray(h), jnp.asarray(patch), jnp.asarray(enable))
    got = tst.add_partial_feature(tb, tcam, torch.tensor(h), torch.tensor(patch), torch.tensor(lam0),
                                  torch.tensor(enable))
    _assert_states_close(state_to_numpy(got), _jax_numpy(want))
    before = state_to_numpy(tb)
    after = state_to_numpy(got)
    for b in (1, 2, 4):             # gate off or no free slot: bit for bit the input
        for k in before:
            np.testing.assert_array_equal(after[k][b], before[k][b], err_msg=(k, b))
    assert (after["next_label"] - before["next_label"]).tolist() == [1, 0, 0, 1, 0]
    # each enabled lane inserted into ITS first free slot
    for b in (0, 3):
        slot = int(np.argmin(before["active"][b]))
        assert after["active"][b, slot] and not after["full"][b, slot]
        np.testing.assert_array_equal(after["patches"][b, slot], patch[b])


def test_convert_feature_over_lanes_matches_jax_onehot_vmap(rng, lanes):
    jb, tb, _cfg = lanes
    slot = np.array([2, 2, 2, 5, 2], np.int32)
    mean = rng.uniform(0.5, 4.0, N_LANES)
    cov = rng.uniform(0.01, 0.2, N_LANES)
    enable = np.array([True, False, True, True, False])
    want = jax.vmap(lambda s, sl, m, c, en: jst.convert_feature(s, sl, m, c, en, onehot=True))(
        jb, jnp.asarray(slot), jnp.asarray(mean), jnp.asarray(cov), jnp.asarray(enable))
    got = tst.convert_feature(tb, torch.tensor(slot), torch.tensor(mean), torch.tensor(cov),
                              torch.tensor(enable))
    _assert_states_close(state_to_numpy(got), _jax_numpy(want))
    before, after = state_to_numpy(tb), state_to_numpy(got)
    for b in (1, 4):
        for k in before:
            np.testing.assert_array_equal(after[k][b], before[k][b], err_msg=(k, b))
    for b in (0, 2, 3):
        off = 13 + 6 * int(slot[b])
        assert after["full"][b, slot[b]] and not after["palive"][b, slot[b]].any()
        assert (after["x"][b, off + 3 : off + 6] == 0).all()
        assert (after["P"][b, off + 3 : off + 6, :] == 0).all()
        assert (after["P"][b, :, off + 3 : off + 6] == 0).all()


@pytest.mark.parametrize("zero_xp", [True, False])
def test_delete_mask_over_lanes_matches_jax_vmap(rng, lanes, zero_xp):
    jb, tb, _cfg = lanes
    MF = jb.active.shape[-1]
    kill = rng.uniform(size=(N_LANES, MF)) > 0.6
    kill[3] = False                                          # a lane that deletes nothing
    want = jax.vmap(lambda s, k: jst.delete_mask(s, k, zero_xp=zero_xp))(jb, jnp.asarray(kill))
    got = tst.delete_mask(tb, torch.tensor(kill), zero_xp=zero_xp)
    want_np, got_np = _jax_numpy(want), state_to_numpy(got)
    for k in want_np:
        np.testing.assert_array_equal(got_np[k], want_np[k].astype(got_np[k].dtype), err_msg=k)
    before = state_to_numpy(tb)
    for k in before:
        np.testing.assert_array_equal(got_np[k][3], before[k][3], err_msg=k)


def test_free_slot_and_accessors_over_lanes(lanes):
    jb, tb, _cfg = lanes
    MF = jb.active.shape[-1]
    slot, any_free = tst.free_slot(tb)
    wslot, wfree = jax.vmap(jst.free_slot)(jb)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(wslot))
    np.testing.assert_array_equal(any_free.numpy(), np.asarray(wfree))
    assert not bool(any_free[1])
    for jf, tf, aj, at in ((jst.slot_pxy, tst.slot_pxy, jb.P, tb.P), (jst.slot_pyy, tst.slot_pyy, jb.P, tb.P),
                           (jst.slot_states, tst.slot_states, jb.x, tb.x)):
        np.testing.assert_array_equal(tf(at, MF).numpy(), np.asarray(jax.vmap(lambda a: jf(a, MF))(aj)))


def test_replicate_states_gives_each_lane_its_own_stream(data_dir):
    cfg = os.path.join(data_dir, "SceneLib2.cfg")
    ts = tst.init_from_config(tload_config(cfg), device=CPU, dtype=torch.float32)
    tb = replicate_states(ts, 6)
    jb = jreplicate(jst.init_from_config(jload_config(cfg)), 6)
    np.testing.assert_array_equal(tb.rng.numpy().astype(np.uint32), np.asarray(jb.rng))
    for k, v in state_to_numpy(tb).items():
        if k != "rng":
            np.testing.assert_array_equal(v, np.broadcast_to(state_to_numpy(ts)[k], v.shape), err_msg=k)
    # lane i draws srand48(i)'s sequence, all lanes in one call
    states, vals = drand48_many(tb.rng, 4)
    for i in range(6):
        ref = Drand48(i)
        np.testing.assert_array_equal(vals[i].numpy(), [ref.next() for _ in range(4)])
        assert unpack_state(states[i, -1].numpy()) == ref.state()
