"""The single stream's split route (D > 384) at max_features_to_init_at_once
= 2 against the JAX f32 step: max_features 64 (D = 397: predict, the
measurement kernel and top-k, the search, the dense update with S inverted
by the Cholesky kernel; the partial slots by top-k over the partial flags,
JAX step.py:351-355), stage 8 under lax.cond(making_any, heavy, light).

The JAX step runs once, in a subprocess (SCENELIB2_X64=0, use_pallas=True,
interpret-mode kernels: ~60-75 s on one core), over the first 40 frames of
the std sequence with mapping on; output indices 11-14 and 18-21 search both
partial slots. The port's CPU replay of those frames decides as JAX does,
frame by frame (tests/torch_maxp_jax.py).
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


def test_maxp2_split_route_mf64_matches_the_jax_step_frame_by_frame(tmp_path):
    want = run_jax_step(tmp_path, N_FRAMES, None, dict(max_features=64, **MAXP2))
    np.testing.assert_array_equal(both_searched(want)[:8], [11, 12, 13, 14, 18, 19, 20, 21])
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=64, device="cpu", **MAXP2)
    assert slam._step.route == "split"
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True)
    assert_same_maxp_run(got, want, "max_features 64, maxp 2")
