"""The port's f64 batch step on the parity route "xla-f64" (precision="f64",
use_pallas=False: every stage in f64 tensor operations, no kernel) against
the vmapped JAX step with batch_mode=True in its f64 parity mode (x64 on),
lane by lane and frame by frame (tests/torch_batch_jax.py: the JAX run, its
pinning to an instruction set without FMA, and what is compared: decisions,
selection sets, init boxes and particle masks exactly, r and q within
1e-8).

4 lanes (2 scene textures x 2 one-frame phase offsets) x 20 frames, with
inits, a conversion and a live ray; and four committed lanes over all 63
frames against expected_fingerprint_batch64_f64.json.
"""

from __future__ import annotations

import dataclasses

import pytest
import torch

from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, make_lanes
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch

from tests.torch_batch_jax import assert_port_equals_jax, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 4, 2, 20


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_port_f64_parity_route_equals_jax_vmapped_x64_step_lane_by_lane(tmp_path_factory, tmp_path):
    want, state0 = run_jax_lanes(tmp_path_factory.mktemp("jax_xla_f64"), N_LANES, N_TEXTURES, N_FRAMES,
                                 "xla", precision="f64")
    got = assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES, "xla",
                                 precision="f64")
    assert got.r.dtype == torch.float64
    assert want["did_init"].any() and want["did_convert"].any()
    assert bool(got.par_alive.any())


def test_port_f64_batch_reproduces_the_committed_lanes(tmp_path):
    """Four of the 64 committed lanes (two textures, both phase offsets),
    all 63 frames, on the f64 parity route: each lane's fingerprint equals
    expected_fingerprint_batch64_f64.json (the JAX x64 batch step's, its
    runs with and without FMA agreeing)."""
    lanes = [0, 1, 32, 33]
    params, states, frames = make_lanes(str(tmp_path), device="cpu", dtype=torch.float64, lanes=lanes)
    params = dataclasses.replace(params, use_pallas=False)
    step = make_batched_step(params, device="cpu", precision="f64")
    assert step.route == "xla-f64" and states.x.dtype == torch.float64
    _states, outs = run_batch(step, states, frames, True, params)
    assert check_lanes(lane_fingerprints(outs), lanes, route=step.route, precision="f64") == []
