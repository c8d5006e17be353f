"""The batch step at max_features_to_init_at_once = 2 on the route "sb0" (SCENELIB2_BATCH_SB=0: K13 searches and K12 updates both slots of every lane on K10's rows in place of K11),
against the vmapped JAX f32 step, lane by lane and frame by frame
(tests/torch_batch_jax.py says what is compared; config "maxp2").

2 lanes (one texture, two phase offsets) x 20 frames, mapping on: both
lanes hold two partial features and search both slots on several frames;
the partial slots (par_slot, top-k over the partial flags) are equal too.
The JAX run takes ~1 min on one core, most of it the compile.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 2, 1, 20
ROUTE = "sb0"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_maxp2_sb0_route_equals_jax_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_maxp2_sb0"), N_LANES, N_TEXTURES, N_FRAMES, ROUTE,
                                 config="maxp2")
    both = want["par_mask"].all(-1)                                 # [T, B]
    assert both.any(0).all(), "each lane searches both partial slots on some frame"
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, ROUTE, config="maxp2")
    assert got.par_slot.shape == (N_FRAMES, N_LANES, 2)
    np.testing.assert_array_equal(got.par_slot.numpy(), want["par_slot"])
    assert want["did_convert"].any()
