"""Batch lanes over a 1-D mesh (parallel/mesh.py: run_batch(mesh=),
shard_batch, gather_batch): 2 gloo ranks spawned with torch.multiprocessing
(one torch thread each, a file:// rendezvous, TIME_LIMIT seconds), each
stepping its contiguous block of 4 batch64 lanes (0, 1, 32, 33) over 5
frames on the default route. The gathered outputs and final states equal
the one-process run_batch lane for lane, bit for bit."""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from scenelib2_torch.runtime.state import SlamState
from tests.torch_spawn import spawn

LANES = [0, 1, 32, 33]
N_FRAMES = 6          # 5 steps a lane
TIME_LIMIT = 300


def _lanes(cache):
    return make_lanes(cache, device="cpu", dtype=torch.float32, lanes=LANES, n_frames=N_FRAMES)


def _save(path, states, outs):
    np.savez(path, **{f"state/{k}": v.numpy() for k, v in zip(SlamState._fields, states)},
             **{f"out/{k}": v.numpy() for k, v in outs._asdict().items()})


def _rank(rank, world, init, cache, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world)
    try:
        from scenelib2_torch.parallel.mesh import gather_batch, make_mesh, shard_batch

        mesh = make_mesh((world,), ("data",), device="cpu")
        params, states, frames = _lanes(cache)
        mine = shard_batch(mesh, states)
        assert mine.x.shape[0] == len(LANES) // world
        assert torch.equal(mine.x, states.x[rank * 2:rank * 2 + 2])
        assert all(torch.equal(a, b) for a, b in zip(gather_batch(mesh, mine), states))
        try:
            shard_batch(mesh, torch.zeros(3))
            raise AssertionError("3 lanes split over 2 ranks")
        except ValueError:
            pass
        step = make_batched_step(params, device="cpu")
        states, outs = run_batch(step, states, frames, True, params, mesh=mesh)
        if rank == 0:
            _save(os.path.join(out_dir, "sharded.npz"), states, outs)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cache = str(tmp_path_factory.mktemp("lanes"))
        out = tmp_path_factory.mktemp("lane_shard")
        params, states, frames = _lanes(cache)      # renders the textures once, for the ranks too
        states, outs = run_batch(make_batched_step(params, device="cpu"), states, frames, True, params)
        _save(out / "one.npz", states, outs)
        spawn(_rank, 2, (f"file://{out}/init", cache, str(out)), TIME_LIMIT)
    finally:
        torch.set_num_threads(n)
    with np.load(out / "one.npz") as a, np.load(out / "sharded.npz") as b:
        return {k: a[k] for k in a.files}, {k: b[k] for k in b.files}


def test_lane_sharded_outputs_equal_run_batch_lane_for_lane(runs):
    one, sharded = runs
    outs = [k for k in one if k.startswith("out/")]
    assert outs and one["out/n_matched"].shape[:2] == (N_FRAMES - 1, len(LANES))
    for k in outs:
        np.testing.assert_array_equal(sharded[k], one[k], err_msg=k)


def test_lane_sharded_final_states_equal_run_batch(runs):
    one, sharded = runs
    for k in SlamState._fields:
        assert sharded[f"state/{k}"].dtype == one[f"state/{k}"].dtype, k
        np.testing.assert_array_equal(sharded[f"state/{k}"], one[f"state/{k}"], err_msg=k)
