"""The port's CPU step against the JAX f32 fast step, frame by frame.

The JAX step runs in a subprocess with SCENELIB2_X64=0 (fast mode is fixed
when JAX initialises; this test process runs JAX with x64), use_pallas=True
(interpret-mode kernels on the CPU) and mapping off, over the first 40
frames of the std synthetic sequence. The port's CPU step takes the same
frames. Per-frame decision fields and selection sets must be identical; the
camera position r and state xv agree within 1e-4.
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
N_FRAMES = 40
STEP_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain path is hundreds of tiny tensor ops per frame: intra-op
    threads only contend with the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# per-frame jitted steps: one compile of the step (~30 s on a CPU) instead
# of the replay scan's unrolled one
_JAX_RUNNER = r"""
import os, sys
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from scenelib2_tpu.eval.synthetic import generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

out_dir, n = sys.argv[1], int(sys.argv[2])
frames, _, _, cfg = generate_dataset(out_dir, n_frames=n + 1)
slam = MonoSLAM(cfg, max_features=16, use_pallas=True)
rec = []
for t in range(1, n + 1):
    slam.go_one_step(frames[t], enable_mapping=False)
    rec.append({k: np.asarray(v) for k, v in slam.last_output._asdict().items()})
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


def test_jax_f32_step_matches_port_frame_by_frame(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    # one compute thread: the suite runs several workers side by side
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(tmp_path), str(N_FRAMES)],
                         capture_output=True, text=True, timeout=400, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp_path / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=16, device="cpu")
    got = slam.run_sequence(want["frames"][1:], enable_mapping=False)
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)))
    for k in ("r", "xv"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=STEP_TOL, err_msg=k)
