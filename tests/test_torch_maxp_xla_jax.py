"""JAX's pure-XLA route in f32 (use_pallas=False, route "xla") at
max_features_to_init_at_once = 2 on the single stream, against the JAX f32
step, frame by frame.

The JAX step runs once, in a subprocess (SCENELIB2_X64=0, use_pallas=False:
no Pallas kernel but the Cholesky inverse of S, ~30-40 s on one core), over
the first 40 frames of the std sequence (max_features 16) with mapping on;
output indices 11-14 and 18-21 search both partial slots. Stage 8 there is
XLA's whole-frame score maps of both slots, the K-form particle chain, the
union-box search and the XLA Bayes chain, behind lax.cond(making_any, heavy,
light). The port's CPU replay decides as JAX does (tests/torch_maxp_jax.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from tests.test_torch_split_step_jax import run_jax_step
from tests.torch_maxp_jax import MAXP2, assert_same_maxp_run, both_searched

N_FRAMES = 40


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_maxp2_xla_route_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, N_FRAMES, None, dict(max_features=16, use_pallas=False, **MAXP2))
    np.testing.assert_array_equal(both_searched(want)[:8], [11, 12, 13, 14, 18, 19, 20, 21])
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=16, device="cpu", use_pallas=False, **MAXP2)
    assert slam._step.route == "xla"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_maxp_run(got, want, "xla route, maxp 2")
