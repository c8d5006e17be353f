"""The f64 batch step at max_features_to_init_at_once = 2 on JAX's two
hybrid batch routes, "k2-f64" (batch_pallas=True: K2 in stage 3) and
"k8-f64" (batch_pallas=False: K8), against the vmapped JAX step in its f64
parity mode (x64 on), lane by lane and frame by frame
(tests/torch_batch_jax.py; r and q within 1e-8). Stage 8 is the f64 tensor
form on both, over both partial slots.

2 lanes (one texture, two phase offsets) x 14 frames each, mapping on: both
lanes search both partial slots.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 2, 1, 14


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("route", ["default", "bp0"], ids=["k2-f64", "k8-f64"])
def test_port_maxp2_f64_hybrid_route_equals_jax_lane_by_lane(route, tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp(f"jax_maxp2_{route}_f64"), N_LANES, N_TEXTURES, N_FRAMES,
                                 route, config="maxp2", precision="f64")
    assert want["par_mask"].all(-1).any(0).all()
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, route, config="maxp2",
                                 precision="f64")
    np.testing.assert_array_equal(got.par_slot.numpy(), want["par_slot"])
