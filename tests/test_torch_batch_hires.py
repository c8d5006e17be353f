"""Batch lanes at BASELINE config 3 (640x480, max_features 60, 200
particles) on the CPU, and the particle limits of the step builders.

Two of the 16 committed batch-hires lanes replay their 39 frames and
reproduce scenelib2_torch/data/expected_fingerprint_batch_hires.json: lane
4, whose output index 26 sits on a rounding-level tie of K6's discriminant
(the JAX runs with and without FMA split there; the committed file and the
port side with exact arithmetic: scripts/batch64_near_ties.py), and lane
13. The builders take every particle count that the JAX kernels pad to a
multiple of 128, on both sides of bayes.CHUNK_NP (the longest row the
particle kernels hold in registers and shared memory; longer rows take the
kernels' workspace path).
"""

from __future__ import annotations

import dataclasses
import tempfile

import pytest
import torch

from scenelib2_torch.config import Params
from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, make_lanes
from scenelib2_torch.eval.fingerprint import load_expected
from scenelib2_torch.kernels.bayes import CHUNK_NP
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from scenelib2_torch.runtime.step import XLA_ROUTE_REFUSED, make_batch_step, make_step

LANES = (4, 13)


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_hires_lanes_reproduce_the_committed_fingerprints():
    with tempfile.TemporaryDirectory() as tmp:
        params, states, frames = make_lanes(tmp, 16, 8, 40, device="cpu", dtype=torch.float32, lanes=LANES,
                                            config="hires")
    assert (params.cam_width, params.max_features, params.n_particles, params.particle_win_radius) == (
        640, 60, 200, 52)
    assert frames.shape == (39, len(LANES), 480, 640)
    _s, outs = run_batch(make_batched_step(params, device="cpu"), states, frames, True, params)
    assert check_lanes(lane_fingerprints(outs), LANES, config="hires") == []
    doc = load_expected("expected_fingerprint_batch_hires")
    assert doc["lanes_from_run_without_fma"] == [4] and doc["n_particles"] == 200
    assert bool(outs.did_convert[:, 0].any()) and bool(outs.par_mask.any())


@pytest.mark.parametrize("NP", [129, 200, 300, 1100, CHUNK_NP])
def test_step_builders_take_every_padded_particle_count(NP):
    p = dataclasses.replace(Params(), n_particles=NP)
    make_step(p, device="cpu")
    make_batched_step(p, device="cpu")
    make_batched_step(p, device="cpu", batch_sb=False)
    make_batched_step(dataclasses.replace(p, batch_pallas=False), device="cpu")


def test_step_builders_refuse_particles_beyond_the_kernels_limit():
    """The particle kernels have no limit any more: one particle past the
    rows they hold in shared memory builds every step, single stream and
    batch, without a refusal."""
    p = dataclasses.replace(Params(), n_particles=CHUNK_NP + 1)
    for build in (make_step, make_batch_step):
        build(p, device="cpu")


def test_xla_route_refusal_names_the_kernel_that_route_launches():
    """The JAX single-stream f32 step with use_pallas=False still inverts S
    with K14 (ekf.joint_update(..., pallas_chol=not batch_mode)); only its
    batch form and f64 launch no kernel."""
    assert "K14" in XLA_ROUTE_REFUSED and "launches no kernel" not in XLA_ROUTE_REFUSED
    assert '"The pure-XLA route in f32"' in XLA_ROUTE_REFUSED
    with pytest.raises(NotImplementedError, match='"f64 parity mode"'):
        make_step(Params(), device="cpu", precision="f64")
    with pytest.raises(NotImplementedError, match='"Single-stream and batch MAXP > 1"'):
        make_step(dataclasses.replace(Params(), max_features_to_init_at_once=2), device="cpu")
