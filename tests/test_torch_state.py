"""scenelib2_torch.runtime.state and convert against the JAX package.

States built by both packages from the same config must agree field for
field, exactly; a state converts between the packages (and through a JAX
checkpoint file) without changing a bit.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scenelib2_tpu.config import load_config as jload_config
from scenelib2_tpu.runtime import state as jst
from scenelib2_tpu.runtime.slam import MonoSLAM as JMonoSLAM
from scenelib2_torch.config import load_config as tload_config
from scenelib2_torch.convert import state_from_jax, state_to_numpy
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.runtime import state as tst
from scenelib2_torch.runtime.slam import MonoSLAM

CPU = torch.device("cpu")



@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synthetic_cfg(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synthetic"))
    return generate_dataset(d, n_frames=2)[3]


def _jax_numpy(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def _assert_fields_equal(got: dict, want: dict):
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        assert got[k].dtype == want[k].dtype, (k, got[k].dtype, want[k].dtype)
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _random_jax_state(rng, cfg_path):
    """A JAX state with every field filled (partial features included)."""
    s = jst.init_from_config(jload_config(cfg_path))
    MF, NP = s.lam.shape
    D = s.x.shape[0]
    A = rng.normal(size=(D, D))
    return s._replace(
        x=jnp.asarray(rng.normal(size=D)),
        P=jnp.asarray(A @ A.T),
        active=jnp.asarray(rng.uniform(size=MF) > 0.3),
        full=jnp.asarray(rng.uniform(size=MF) > 0.5),
        label=jnp.asarray(rng.integers(-1, 50, MF).astype(np.int32)),
        patches=jnp.asarray(rng.integers(0, 256, (MF, 11, 11)).astype(np.uint8)),
        xp_org=jnp.asarray(rng.normal(size=(MF, 7))),
        attempts=jnp.asarray(rng.integers(0, 20, MF).astype(np.int32)),
        successes=jnp.asarray(rng.integers(0, 20, MF).astype(np.int32)),
        lam=jnp.asarray(rng.uniform(0.5, 5.0, (MF, NP))),
        prob=jnp.asarray(rng.uniform(size=(MF, NP))),
        palive=jnp.asarray(rng.uniform(size=(MF, NP)) > 0.5),
        match_attempts=jnp.asarray(rng.integers(0, 9, MF).astype(np.int32)),
        sched=jnp.asarray(rng.uniform(size=MF) > 0.7),
        rng=jnp.asarray(rng.integers(0, 1 << 16, 3).astype(np.uint32)),
        next_label=jnp.int32(51),
        frame_no=jnp.int32(17),
    )


@pytest.mark.parametrize("which", ["stock", "synthetic"])
def test_init_from_config_matches_jax(which, data_dir, synthetic_cfg):
    path = os.path.join(data_dir, "SceneLib2.cfg") if which == "stock" else synthetic_cfg
    want = _jax_numpy(jst.init_from_config(jload_config(path)))
    got = state_to_numpy(tst.init_from_config(tload_config(path), device=CPU, dtype=torch.float64))
    _assert_fields_equal(got, want)
    # the f32 state is the f64 one rounded once
    got32 = state_to_numpy(tst.init_from_config(tload_config(path), device=CPU, dtype=torch.float32))
    for k in ("x", "P", "xp_org", "lam", "prob"):
        np.testing.assert_array_equal(got32[k], want[k].astype(np.float32), err_msg=k)


def test_patch_row_matches_jax(rng):
    for _ in range(5):
        p = rng.integers(0, 256, (11, 11)).astype(np.uint8)
        np.testing.assert_array_equal(
            tst.patch_row(torch.tensor(p)).numpy(), np.asarray(jst.patch_row(jnp.asarray(p))))


@pytest.mark.parametrize("zero_xp", [True, False])
def test_delete_mask_matches_jax(rng, data_dir, zero_xp):
    js = _random_jax_state(rng, os.path.join(data_dir, "SceneLib2.cfg"))
    MF = js.active.shape[0]
    kill = rng.uniform(size=MF) > 0.6
    want = _jax_numpy(jst.delete_mask(js, jnp.asarray(kill), zero_xp=zero_xp))
    ts = state_from_jax(_jax_numpy(js), CPU, torch.float64)
    got = state_to_numpy(tst.delete_mask(ts, torch.tensor(kill), zero_xp=zero_xp))
    _assert_fields_equal(got, want)


def test_slot_accessors_match_jax(rng, data_dir):
    js = _random_jax_state(rng, os.path.join(data_dir, "SceneLib2.cfg"))
    ts = state_from_jax(_jax_numpy(js), CPU, torch.float64)
    MF = js.active.shape[0]
    for jf, tf, arr_j, arr_t in (
        (jst.slot_pxy, tst.slot_pxy, js.P, ts.P),
        (jst.slot_pyy, tst.slot_pyy, js.P, ts.P),
        (jst.slot_states, tst.slot_states, js.x, ts.x),
    ):
        np.testing.assert_array_equal(tf(arr_t, MF).numpy(), np.asarray(jf(arr_j, MF)))
    assert tst.slot_offset(5) == jst.slot_offset(5)


def test_state_round_trip_through_jax_checkpoint(rng, data_dir, tmp_path):
    cfg = os.path.join(data_dir, "SceneLib2.cfg")
    slam = JMonoSLAM(cfg)
    slam.state = _random_jax_state(rng, cfg)
    path = str(tmp_path / "ckpt.npz")
    slam.save_checkpoint(path)
    want = _jax_numpy(slam.state)
    with np.load(path) as data:
        ckpt = {k: data[k] for k in data.files}
    assert all(k.startswith("state_") for k in ckpt)
    # by checkpoint key and by field name, both exact in f64
    _assert_fields_equal(state_to_numpy(state_from_jax(ckpt, CPU, torch.float64)), want)
    _assert_fields_equal(state_to_numpy(state_from_jax(want, CPU, torch.float64)), want)
    # an older checkpoint without sched / patch_rows: defaults as the JAX loader's
    old = {k: v for k, v in ckpt.items() if k not in ("state_sched", "state_patch_rows")}
    conv = state_to_numpy(state_from_jax(old, CPU, torch.float64))
    assert not conv["sched"].any()
    np.testing.assert_array_equal(
        conv["patch_rows"], np.stack([np.asarray(jst.patch_row(jnp.asarray(p))) for p in want["patches"]]))


def test_load_jax_checkpoint_with_partial_features(rng, data_dir, tmp_path):
    """A JAX checkpoint loads into the port exactly, with or without a
    partially initialised feature: the particle stage is ported, so a state
    holding one is no longer refused."""
    cfg = os.path.join(data_dir, "SceneLib2.cfg")
    jslam = JMonoSLAM(cfg)
    tslam = MonoSLAM(cfg, device="cpu")
    # a tracking-only state (no partial feature) loads and matches exactly
    path = str(tmp_path / "clean.npz")
    jslam.save_checkpoint(path)
    tslam.load_jax_checkpoint(path)
    want = _jax_numpy(jslam.state)
    got = state_to_numpy(tslam.state)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
    # a state with a partially initialised feature loads as well
    s = _random_jax_state(rng, cfg)
    jslam.state = s._replace(active=s.active.at[0].set(True), full=s.full.at[0].set(False))
    path2 = str(tmp_path / "partial.npz")
    jslam.save_checkpoint(path2)
    tslam.load_jax_checkpoint(path2)
    want = _jax_numpy(jslam.state)
    got = state_to_numpy(tslam.state)
    assert got["active"][0] and not got["full"][0]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k].astype(got[k].dtype), err_msg=k)
