"""The port's CPU step with mapping on against the JAX f32 fast step.

The JAX step runs once, in a subprocess, with SCENELIB2_X64=0 (fast mode is
fixed when JAX initialises; this test process runs JAX with x64),
use_pallas=True (interpret-mode kernels on the CPU: ~35 s on one core,
almost all of it the first step's compile) and mapping on, over the first
30 frames of the std synthetic sequence: four auto-inits (output indices 9,
15, 22, 28) and two ray -> point conversions (20, 27). It saves its
checkpoint after frame 12, when it holds a partial feature.

  (a) the port's CPU replay of the same frames: per-frame decision fields,
      selection sets, the init box and the particle-search masks are
      identical; the camera position r and state xv agree within 1e-4;
  (b) the port loads the JAX checkpoint (partial feature included) and
      continues over frames 13..30 with the same decisions, r and xv within
      1e-4.
"""

from __future__ import annotations

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
N_FRAMES = 30
CKPT_AFTER = 12
STEP_TOL = 1e-4
EXACT_FIELDS = ("init_box", "par_slot", "par_mask", "par_alive")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JAX_RUNNER = r"""
import os, sys
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from scenelib2_tpu.eval.synthetic import generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

out_dir, n, ckpt_after = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
frames, _, _, cfg = generate_dataset(out_dir, n_frames=n + 1)
slam = MonoSLAM(cfg, max_features=16, use_pallas=True)
rec = []
for t in range(1, n + 1):
    slam.go_one_step(frames[t], enable_mapping=True)
    rec.append({k: np.asarray(v) for k, v in slam.last_output._asdict().items()})
    if t == ckpt_after:
        slam.save_checkpoint(os.path.join(out_dir, 'ckpt.npz'))
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_mapping")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    # one compute thread: the suite runs several workers side by side
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run(
        [sys.executable, "-c", _JAX_RUNNER, str(out), str(N_FRAMES), str(CKPT_AFTER)],
        capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    return out, want


def _assert_same_run(got, want: dict, what: str):
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=f"{what}: {name}")
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)),
                                  err_msg=what)
    for k in ("r", "xv"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=STEP_TOL,
                                   err_msg=f"{what}: {k}")


def test_jax_f32_step_with_mapping_matches_port_frame_by_frame(jax_run):
    out, want = jax_run
    np.testing.assert_array_equal(np.flatnonzero(want["did_init"]), [9, 15, 22, 28])
    np.testing.assert_array_equal(np.flatnonzero(want["did_convert"]), [20, 27])
    slam = MonoSLAM(str(out / "synthetic.cfg"), max_features=16, device="cpu")
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    _assert_same_run(got, want, "replay")
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)


def test_jax_checkpoint_with_a_partial_feature_continues_identically(jax_run):
    out, want = jax_run
    slam = MonoSLAM(str(out / "synthetic.cfg"), max_features=16, device="cpu")
    slam.load_jax_checkpoint(str(out / "ckpt.npz"))
    assert bool((slam.state.active & ~slam.state.full).any())
    assert int(slam.state.frame_no) == CKPT_AFTER
    got = slam.run_sequence(want["frames"][CKPT_AFTER + 1 :], enable_mapping=True)
    tail = {k: v[CKPT_AFTER:] for k, v in want.items() if k != "frames"}
    _assert_same_run(got, tail, "after the checkpoint")
