"""The port's batch step at BASELINE config 3 (640x480, max_features 60,
search radius 48, particle radius 52, 200 particles) on the CPU against the
JAX batch step on its default route, lane by lane and frame by frame
(tests/torch_batch_jax.py: the JAX run, its pinning to an instruction set
without FMA, and what is compared).

Two lanes of the hires texture of seed 7 at phase offsets 0 and 1, 12
frames: past the first conversion (output index 10 of the hires sequence).
At 200 particles every particle row is 256 lanes wide (K10's prediction
rows, K11's rows, the Bayes sums), where the port's kernels held at most
128 particles before. The JAX run takes about a minute on one core.
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


def test_port_batch_step_equals_jax_at_hires_lane_by_lane(tmp_path_factory, tmp_path):
    assert_hires_route_equals_jax("default", tmp_path_factory, tmp_path)
