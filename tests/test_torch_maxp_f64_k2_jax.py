"""JAX's f64 parity mode (x64 on) at max_features_to_init_at_once = 2 on the
single stream, JAX's hybrid route "k2-f64" (use_pallas=True: the NSSD search kernel in stage 3 on f32 casts of S^-1, everything else in f64 XLA), against the JAX step frame by frame.

The JAX step runs once, in a subprocess with x64 on (the JAX package's
default process; tests/test_torch_split_step_jax.py::run_jax_step with
x64=True, one compute thread: ~50 s), over the first 40 frames of the std
sequence (max_features 16) with mapping on; output indices 11-14 and 18-21
search both partial slots. Stage 8 in f64 is the f64 score maps of both
slots, the reference-order per-slot particle chain, the dense search and
the XLA Bayes chain, behind lax.cond(making_any, heavy, light). The port's
CPU f64 replay decides as JAX does, r, xv and the alive particles' rows
within 1e-8 (tests/torch_maxp_jax.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from tests.test_torch_split_step_jax import run_jax_step
from tests.torch_maxp_jax import F64_TOL, MAXP2, assert_same_maxp_run, both_searched

N_FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_maxp2_k2_f64_route_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, N_FRAMES, None, dict(max_features=16, use_pallas=True, **MAXP2), x64=True)
    assert want["r"].dtype == np.float64
    np.testing.assert_array_equal(both_searched(want)[:8], [11, 12, 13, 14, 18, 19, 20, 21])
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=16, device="cpu", precision="f64",
                    use_pallas=True, **MAXP2)
    assert slam._step.route == "k2-f64"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_maxp_run(got, want, "k2-f64 route, maxp 2", step_tol=F64_TOL, rows_rtol=F64_TOL)
