"""The port's split route (D > 384) against the JAX f32 step, frame by frame.

max_features = 64 (D = 397) on the first 30 frames of the std synthetic
sequence, mapping on. The JAX step takes its split route there
(scenelib2_tpu/runtime/step.py:261-304, 351-384, 434-465, 492-540: predict,
the measurement kernel and top-k, the search, the dense update with
pallas_chol=True) and selects stage 8 by lax.cond(making_any, heavy, light)
(step.py:649-660). The run holds four auto-inits (output indices 9, 15,
22, 28), each a frame whose fresh partial feature is not measurable yet, so
stage 8 takes `light`, and two ray -> point conversions (20, 27).

The JAX step runs once, in a subprocess, with SCENELIB2_X64=0 and
use_pallas=True (interpret-mode kernels on the CPU: ~60 s on one core,
almost all of it the first step's compile). The port's CPU replay of the
same frames must give identical per-frame decision fields, selection sets,
init boxes and particle-search slots and masks (par_slot, par_mask,
par_alive); the particle rows par_h / par_sinv are zero exactly where JAX's
are (the `light` frames) and elsewhere agree to 1e-3 of each field's
largest entry (they are predicted from states that agree to ~1e-5); the
camera position r and state xv agree within 1e-4.
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
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_TOL = 1e-4
ROWS_RTOL = 1e-3
EXACT_FIELDS = ("init_box", "par_slot", "par_mask", "par_alive")

_JAX_RUNNER = r"""
import json, os, sys
x64, ckpt_at = sys.argv[5] == '1', int(sys.argv[6])
if not x64:
    os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import jax.numpy as jnp
import numpy as np
from scenelib2_tpu.config import Params
from scenelib2_tpu.eval.synthetic import generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

assert (jnp.zeros(()).dtype == jnp.float64) == x64
out_dir, n = sys.argv[1], int(sys.argv[2])
dataset, overrides = json.loads(sys.argv[3]), json.loads(sys.argv[4])
frames, _, _, cfg = generate_dataset(out_dir, n_frames=n + 1,
                                     params=Params(**dataset) if dataset else None)
slam = MonoSLAM(cfg, **{'use_pallas': True, **overrides})
rec = []
for t in range(1, n + 1):
    slam.go_one_step(frames[t], enable_mapping=True)
    rec.append({k: np.asarray(v) for k, v in slam.last_output._asdict().items()})
    if t == ckpt_at:
        slam.save_checkpoint(os.path.join(out_dir, 'jax_ckpt.npz'))
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


def run_jax_step(out_dir, n_frames: int, dataset: dict | None, overrides: dict, x64: bool = False,
                 checkpoint_at: int = 0) -> dict:
    """The JAX step's outputs over frames 1..n_frames of the synthetic
    sequence (dataset Params, None for the std config file), with the
    MonoSLAM overrides; the frames under "frames" and the config file in
    out_dir/synthetic.cfg. The step is the f32 fast mode, or with x64 the
    JAX package's f64 parity mode (its default process: x64 on); with
    checkpoint_at = t > 0 the JAX checkpoint after frame t is
    out_dir/jax_ckpt.npz."""
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_ENABLE_X64", "SCENELIB2_X64")}
    env["PYTHONPATH"] = REPO
    # one compute thread: the suite runs several workers side by side
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, str(out_dir), str(n_frames), json.dumps(dataset or {}),
         json.dumps(overrides), "1" if x64 else "0", str(checkpoint_at)],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(os.path.join(out_dir, "jax_outs.npz")) as z:
        return {k: z[k] for k in z.files}


def assert_same_run(got, want: dict, what: str, step_tol: float = STEP_TOL, rows_rtol: float = ROWS_RTOL):
    """got (the port's StepOutputs with a time axis) against the JAX step's
    outputs, frame by frame (the module docstring; the f64 tests pass 1e-8
    for both tolerances)."""
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)),
                                  err_msg=what)
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=f"{what}: {name}")
    for name in ("par_h", "par_sinv"):
        g, w = getattr(got, name).numpy(), want[name]
        np.testing.assert_array_equal(g == 0, w == 0, err_msg=f"{what}: {name} zeros")
        np.testing.assert_allclose(g, w, rtol=0, atol=rows_rtol * np.abs(w).max(), err_msg=f"{what}: {name}")
    for k in ("r", "xv"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=step_tol,
                                   err_msg=f"{what}: {k}")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_split_route_mf64_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, 30, None, dict(max_features=64))
    np.testing.assert_array_equal(np.flatnonzero(want["did_init"]), [9, 15, 22, 28])
    np.testing.assert_array_equal(np.flatnonzero(want["did_convert"]), [20, 27])
    light = (want["n_partial"] > 0) & ~want["par_mask"].any(-1)
    assert light[[9, 15, 22, 28]].all()
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=64, device="cpu")
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_run(got, want, "max_features 64")
