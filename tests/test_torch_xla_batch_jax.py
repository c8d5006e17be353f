"""The port's batch step on the pure-XLA route (use_pallas=False: bp0's
tensor operations with the windowed XLA search of
correlate.elliptical_search_batch and the XLA Bayes chain; no kernel)
against the vmapped JAX step with batch_mode=True, use_pallas=False, lane
by lane and frame by frame (tests/torch_batch_jax.py: the JAX run, its
pinning to an instruction set without FMA, and what is compared: decisions,
selection sets, init boxes and particle masks exactly, r and q within
1e-4).

8 lanes (4 scene textures x 2 one-frame phase offsets) x 20 frames, with
inits, a conversion and lanes with and without a live ray.
"""

from __future__ import annotations

import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, history, lane, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 8, 4, 20
ROUTE = "xla"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_xla_route_equals_jax_vmapped_step_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_xla"), N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, ROUTE)
    assert len({history(lane(want, b)) for b in range(N_LANES)}) >= 4
    assert want["did_init"].any() and want["did_convert"].any()
    assert bool(got.par_alive.any())
