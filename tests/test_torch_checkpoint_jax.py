"""Checkpoints move both ways between the port and the JAX package.

The port's MonoSLAM.save_checkpoint writes the JAX package's layout (an npz
of state_<field> arrays and <path>.json with params and marked), and its
load_checkpoint keeps the JAX loader's rules. On tests/test_facade.py's small
configuration (160x120, max_features 8, 16 particles, NSEL 4), with mapping
on:

  - the port steps 8 frames and saves; the JAX f32 facade (a subprocess with
    SCENELIB2_X64=0) loads that file and steps frame 9: its decisions equal
    the port's own frame 9, x within STEP_TOL;
  - the JAX facade steps 8 frames and saves; the port loads the file (the
    state equals the JAX state exactly) and steps frame 9: its decisions
    equal JAX's frame 9;
  - a checkpoint of another capacity raises ValueError naming max_features;
    unknown and missing fields raise; a file without sched and patch_rows
    (older writers) loads with them derived; an f64 checkpoint of the JAX
    package's parity mode loads cast to f32; reset clears the marked label.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.convert import state_to_numpy
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set
from scenelib2_torch.runtime.state import patch_row

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
N_SAVE = 8
OVERRIDES = dict(max_features=8, n_particles=16, n_features_to_select=4, n_features_to_keep_visible=4,
                 min_particles=4)
SMALL = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0, **OVERRIDES)

_JAX_RUNNER = r"""
import os, sys, pickle
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from scenelib2_tpu.runtime.slam import MonoSLAM

work, cfg, n = sys.argv[1], sys.argv[2], int(sys.argv[3])
overrides = eval(sys.argv[4])
frames = np.load(os.path.join(work, 'frames.npy'))

def out(slam):
    return {k: np.asarray(v) for k, v in slam.last_output._asdict().items()}

res = {}
slam = MonoSLAM(cfg, use_pallas=True, **overrides)
slam.load_checkpoint(os.path.join(work, 'port.npz'))
res['port_state_in_jax'] = {k: np.asarray(v) for k, v in slam.state._asdict().items()}
slam.go_one_step(frames[n + 1])
res['next_from_port'] = out(slam)
res['x_from_port'] = np.asarray(slam.state.x)
slam = MonoSLAM(cfg, use_pallas=True, **overrides)
for t in range(1, n + 1):
    slam.go_one_step(frames[t])
slam.save_checkpoint(os.path.join(work, 'jax.npz'))
res['jax_state'] = {k: np.asarray(v) for k, v in slam.state._asdict().items()}
slam.go_one_step(frames[n + 1])
res['next_from_jax'] = out(slam)
res['x_from_jax'] = np.asarray(slam.state.x)
with open(os.path.join(work, 'res.pkl'), 'wb') as f:
    pickle.dump(res, f)
"""


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from scenelib2_torch.config import Params
    from scenelib2_torch.eval.synthetic import generate_dataset

    work = tmp_path_factory.mktemp("ckpt")
    frames, _rs, _qs, cfg = generate_dataset(str(work), n_frames=N_SAVE + 2, params=Params(**SMALL))
    np.save(work / "frames.npy", frames)
    return work, frames, cfg


@pytest.fixture(scope="module")
def both(world):
    import pickle

    work, frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    for t in range(1, N_SAVE + 1):
        slam.go_one_step(frames[t])
    slam.mark_feature_by_lab(2)
    slam.save_checkpoint(str(work / "port.npz"))
    saved = state_to_numpy(slam.state)
    slam.go_one_step(frames[N_SAVE + 1])
    own_next = slam.last_output
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(work), cfg, str(N_SAVE), repr(OVERRIDES)],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with open(work / "res.pkl", "rb") as f:
        jax_res = pickle.load(f)
    return saved, own_next, slam, jax_res


def _same_decisions(got, want: dict, what: str):
    g = SimpleNamespace(**{k: np.asarray(v)[None] for k, v in got._asdict().items()})
    w = SimpleNamespace(**{k: v[None] for k, v in want.items()})
    for name in DECISION_FIELDS:
        assert int(getattr(g, name)[0]) == int(getattr(w, name)[0]), (what, name)
    np.testing.assert_array_equal(selection_set(g), selection_set(w), err_msg=what)
    np.testing.assert_allclose(np.asarray(got.xv), want["xv"], rtol=0, atol=STEP_TOL, err_msg=what)


def test_port_checkpoint_loads_in_jax_and_steps_the_same(both, world):
    saved, own_next, _slam, jax_res = both
    work = world[0]
    for k, v in jax_res["port_state_in_jax"].items():
        np.testing.assert_array_equal(v, saved[k].astype(v.dtype), err_msg=k)
    _same_decisions(own_next, jax_res["next_from_port"], "JAX's step after the port's checkpoint")
    with open(str(work / "port.npz") + ".json") as f:
        meta = json.load(f)
    assert meta["marked"] == 2 and meta["params"]["max_features"] == OVERRIDES["max_features"]


def test_jax_checkpoint_loads_in_the_port_and_steps_the_same(both, world):
    _saved, _own, _slam, jax_res = both
    work, frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam.load_checkpoint(str(work / "jax.npz"))
    got = state_to_numpy(slam.state)
    for k, v in jax_res["jax_state"].items():
        np.testing.assert_array_equal(got[k], v.astype(got[k].dtype), err_msg=k)
    slam.go_one_step(frames[N_SAVE + 1])
    _same_decisions(slam.last_output, jax_res["next_from_jax"], "the port's step after JAX's checkpoint")
    np.testing.assert_allclose(slam.state.x.numpy(), jax_res["x_from_jax"], rtol=0, atol=STEP_TOL)


def test_capacity_mismatch_raises_naming_max_features(world):
    work, _frames, cfg = world
    other = MonoSLAM(cfg, device="cpu", **dict(OVERRIDES, max_features=10))
    with pytest.raises(ValueError, match="max_features=10"):
        other.load_checkpoint(str(work / "port.npz"))


def test_unknown_and_missing_fields_raise(world, tmp_path):
    work, _frames, cfg = world
    with np.load(str(work / "port.npz")) as z:
        arrays = {k: z[k] for k in z.files}
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    np.savez(tmp_path / "extra.npz", **arrays, state_bogus=np.zeros(3))
    with pytest.raises(ValueError, match="unknown state fields"):
        slam.load_checkpoint(str(tmp_path / "extra.npz"))
    np.savez(tmp_path / "short.npz", **{k: v for k, v in arrays.items() if k != "state_lam"})
    with pytest.raises(ValueError, match="missing state fields"):
        slam.load_checkpoint(str(tmp_path / "short"))


def test_older_file_without_sched_and_patch_rows_loads(world, tmp_path):
    work, _frames, cfg = world
    with np.load(str(work / "port.npz")) as z:
        arrays = {k: z[k] for k in z.files if k not in ("state_sched", "state_patch_rows")}
    np.savez(tmp_path / "old.npz", **arrays)
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam.load_checkpoint(str(tmp_path / "old.npz"))
    assert not bool(slam.state.sched.any())
    torch.testing.assert_close(slam.state.patch_rows, patch_row(torch.as_tensor(arrays["state_patches"])),
                               rtol=0, atol=0)


def test_f64_jax_checkpoint_loads_cast(world, tmp_path):
    """This process runs JAX with x64: its facade's state is the parity
    mode's f64 state, and its checkpoint loads cast to the port's f32."""
    import jax.numpy as jnp

    from scenelib2_tpu.runtime.slam import MonoSLAM as JMonoSLAM

    _work, _frames, cfg = world
    jslam = JMonoSLAM(cfg, **OVERRIDES)
    x = np.asarray(jslam.state.x).copy()
    x[13:16] = [0.1 + 1e-12, -0.2, 0.3]
    jslam.state = jslam.state._replace(x=jnp.asarray(x))
    assert jslam.state.x.dtype == jnp.float64
    jslam.save_checkpoint(str(tmp_path / "f64.npz"))
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam.load_checkpoint(str(tmp_path / "f64.npz"))
    assert slam.state.x.dtype == torch.float32
    np.testing.assert_array_equal(slam.state.x.numpy(), x.astype(np.float32))
    np.testing.assert_array_equal(slam.state.P.numpy(), np.asarray(jslam.state.P).astype(np.float32))


def test_reset_clears_the_mark(both):
    _saved, _own, slam, _res = both
    slam.mark_feature_by_lab(1)
    assert slam.marked_feature_label == 1
    slam.reset()
    assert slam.marked_feature_label == -1
    assert slam.trajectory().shape == (0,)
