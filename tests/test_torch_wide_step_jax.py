"""The port's CPU step at a search radius and an init region past the caps
its kernels once had (search_win_radius 110, init_search_width 100: K2's
windows of 221 x 221 centres, K6's region window of 112 x 72 pixels), held
to the JAX f32 fast step decision by decision.

The JAX step runs once, in a subprocess, with SCENELIB2_X64=0 (fast mode is
fixed when JAX initialises), use_pallas=True (interpret-mode kernels on the
CPU) and mapping on, over the first N_FRAMES frames of the std synthetic
sequence; the port replays the same frames on the CPU. Per-frame decision
fields, selection sets, the init box and the particle-search masks are
identical; r and xv agree within 1e-4 (tests/test_torch_mapping_step_jax.py
holds the default configuration the same way). On the card chip_smoke.py
holds the CUDA run of the same configuration to this CPU run.
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
N_FRAMES = 14
STEP_TOL = 1e-4
WIDE = dict(search_win_radius=110, init_search_width=100)
EXACT_FIELDS = ("init_box", "par_slot", "par_mask", "par_alive")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
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

out_dir, n = sys.argv[1], int(sys.argv[2])
frames, _, _, cfg = generate_dataset(out_dir, n_frames=n + 1)
slam = MonoSLAM(cfg, max_features=16, use_pallas=True, search_win_radius=110, init_search_width=100)
rec = []
for t in range(1, n + 1):
    slam.go_one_step(frames[t], enable_mapping=True)
    rec.append({k: np.asarray(v) for k, v in slam.last_output._asdict().items()})
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.stack([r[k] for r in rec]) for k in rec[0]})
"""


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_wide")
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(out), str(N_FRAMES)],
                         capture_output=True, text=True, timeout=900, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(out / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    return out, want


def test_wide_radius_and_region_match_the_jax_step_frame_by_frame(jax_run):
    out, want = jax_run
    assert want["did_init"].any()     # K6 ran on the 112 x 72 window
    slam = MonoSLAM(str(out / "synthetic.cfg"), max_features=16, device="cpu", **WIDE)
    assert (slam.params.search_win_radius, slam.params.init_search_width) == (110, 100)
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)))
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(), want[name], err_msg=name)
    for k in ("r", "xv"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=STEP_TOL, err_msg=k)
