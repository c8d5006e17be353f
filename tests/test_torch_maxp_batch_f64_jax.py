"""The f64 batch step at max_features_to_init_at_once = 2 on the parity
route "xla-f64" (use_pallas=False: no kernel), against the vmapped JAX step
in its f64 parity mode (x64 on), lane by lane and frame by frame
(tests/torch_batch_jax.py; r and q within 1e-8).

2 lanes (one texture, two phase offsets) x 20 frames, mapping on: both
lanes search both partial slots on several frames (the f64 score maps of
both slots, the reference-order particle chain, the dense search and the
XLA Bayes chain).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 2, 1, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_maxp2_xla_f64_route_equals_jax_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_maxp2_f64"), N_LANES, N_TEXTURES, N_FRAMES, "xla",
                                 config="maxp2", precision="f64")
    assert want["par_mask"].all(-1).any(0).all()
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, "xla", config="maxp2",
                                 precision="f64")
    assert got.r.dtype == torch.float64
    np.testing.assert_array_equal(got.par_slot.numpy(), want["par_slot"])
