"""The port's batch step at BASELINE config 3 (640x480, 200 particles) on
the alternative JAX batch route "bp0" (batch_pallas=False: the XLA
measurement chain, K8, the XLA Shi-Tomasi and score maps, the dense particle
search over 200 particles and K12 on the 13 separate rows), on the CPU against the vmapped JAX step lane by lane and frame by
frame (tests/torch_batch_jax.py). Two lanes of the hires texture of seed 7,
12 frames, as tests/test_torch_batch_hires_step_jax.py runs the default
route; the JAX run takes under a minute on one core.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_batch_jax import assert_hires_route_equals_jax


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_bp0_route_equals_jax_at_hires_lane_by_lane(tmp_path_factory, tmp_path):
    assert_hires_route_equals_jax("bp0", tmp_path_factory, tmp_path)
