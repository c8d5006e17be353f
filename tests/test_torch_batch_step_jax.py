"""The port's batch step on the CPU against the JAX batch step on its
default route (batch_pallas=True), lane by lane and frame by frame
(tests/torch_batch_jax.py: the JAX run, its pinning to an instruction set
without FMA, and what is compared).

The JAX run takes about a minute on one core, most of it the compile. The
lanes are the bench_batch64 recipe at 8 lanes: 4 scene textures x 2
one-frame phase offsets, 24 frames. The lanes really diverge: at least 4
distinct decision histories among the 8.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tests.torch_batch_jax import assert_port_equals_jax, history, lane, run_jax_lanes

N_LANES, N_TEXTURES, N_FRAMES = 8, 4, 24


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    return run_jax_lanes(tmp_path_factory.mktemp("jax_batch"), N_LANES, N_TEXTURES, N_FRAMES)


def test_port_batch_step_equals_jax_vmapped_step_lane_by_lane(jax_run, tmp_path):
    want, state0 = jax_run
    assert_port_equals_jax(want, state0, tmp_path, N_LANES, N_TEXTURES, N_FRAMES)

    # the lanes diverge, in the reference as in the port
    assert len({history(lane(want, b)) for b in range(N_LANES)}) >= 4
    assert want["did_init"].any() and want["did_convert"].any()
    assert len(set(want["n_active"][-1].tolist())) > 1
    # a lane with no partial feature steps beside a lane with a live ray
    n_partial_before = np.concatenate([np.zeros((1, N_LANES), np.int64), want["n_partial"][:-1]])
    assert ((n_partial_before == 0).any(axis=1) & (n_partial_before > 0).any(axis=1)).any()
