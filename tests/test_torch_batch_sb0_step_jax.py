"""The port's batch step on the CPU against the JAX batch step on its route
with batch_pallas=True with SCENELIB2_BATCH_SB=0 (route B: K7, K2, K6, K9, K10, then K13 and K12 on K10's rows in place of K11), lane by lane and frame by frame (tests/torch_batch_jax.py: the
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
ROUTE = "sb0"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_sb0_route_equals_jax_vmapped_step_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_sb0"), N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    assert len({history(lane(want, b)) for b in range(N_LANES)}) >= 4
    assert want["did_init"].any() and want["did_convert"].any()
