"""The port's batch step on the CPU against the JAX batch step on its route
with batch_pallas=False (route A: the XLA measurement chain, K8 on gathered windows, the XLA Shi-Tomasi, XLA score maps, the K-form chain, the dense particle search, K12 on 13 rows), lane by lane and frame by frame (tests/torch_batch_jax.py: the
JAX run, its pinning to an instruction set without FMA, and what is
compared).

8 lanes (4 scene textures x 2 one-frame phase offsets) x 20 frames, with
inits, a conversion and lanes with and without a live ray.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, history, lane, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 8, 4, 20
ROUTE = "bp0"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_bp0_route_equals_jax_vmapped_step_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_bp0"), N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    assert len({history(lane(want, b)) for b in range(N_LANES)}) >= 4
    assert want["did_init"].any() and want["did_convert"].any()
