"""go_one_step through the one-step graph (runtime/replay.py::replay_one),
held on the CPU with the stand-in graph of tests/test_torch_replay.py (the
captured step is called at each replay, on the graph's static inputs, and
its final state is handed back as the captured graph does):

  - a facade script that alternates mapping on and off and changes the
    state between calls (initialise_feature, initialise_auto_feature,
    delete_feature, add_new_known_feature, load_checkpoint, reset) gives
    the same packed row and the same state after every call as the eager
    step, bit for bit;
  - the one-step graph is the one run_sequence replays past its last full
    block (one key), and flipping enable_mapping makes exactly one more, so
    both fit MAX_GRAPHS beside run_sequence's block graphs;
  - a state the caller holds does not change under a later replay, and the
    state handed back is not the graph's.
On the card, chip_smoke.py phase 3g holds the real graph to the eager step.
"""

from __future__ import annotations

import contextlib

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.runtime import replay
from scenelib2_torch.runtime.step import pack_outputs
from tests.test_torch_replay import _EagerStepGraph

OVERRIDES = dict(max_features=8, n_particles=16, n_features_to_select=4, n_features_to_keep_visible=6,
                 min_particles=4, init_search_width=24, init_search_height=18, feature_separation_min=5)
SMALL = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0, **OVERRIDES)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from scenelib2_torch.eval.synthetic import generate_dataset

    d = tmp_path_factory.mktemp("one_step")
    frames, rs, qs, cfg = generate_dataset(str(d), n_frames=24, params=Params(**SMALL))
    return str(d), frames, rs, qs, cfg


@pytest.fixture
def stand_in(monkeypatch):
    monkeypatch.setattr(replay, "StepGraph", _EagerStepGraph)
    monkeypatch.setattr(replay, "sync_error", contextlib.nullcontext)


def _script(slam, step, frames, rs, qs, work):
    """The facade calls; step(slam, frame, mapping) is the go_one_step under
    test. Returns (tag, packed row or None, state) after every call."""
    recs = []

    def rec(tag, row=None):
        recs.append((tag, row, tuple(t.clone() for t in slam.state)))

    for t in range(1, 11):
        step(slam, frames[t], t % 3 != 0)           # mapping on, on, off, ...
        rec(f"step {t}", pack_outputs(slam.last_output))
    slam.initialise_feature(frames[10], 80, 60)
    rec("initialise_feature")
    slam.initialise_auto_feature(frames[10])
    rec("initialise_auto_feature")
    slam.mark_feature_by_lab(1)
    slam.delete_feature()
    rec("delete_feature")
    slam.add_new_known_feature(np.array([0.05, -0.02, 0.0]), np.concatenate([rs[10], qs[10]]),
                               frames[10][50:61, 70:81])
    rec("add_new_known_feature")
    slam.save_checkpoint(work + "/ck.npz")
    for t in range(11, 16):
        step(slam, frames[t], True)
        rec(f"step {t}", pack_outputs(slam.last_output))
    slam.load_checkpoint(work + "/ck.npz")
    for t in range(11, 21):
        step(slam, frames[t], t % 2 == 0)
        rec(f"step {t} after load", pack_outputs(slam.last_output))
    slam.reset()
    for t in range(1, 4):
        step(slam, frames[t], True)
        rec(f"step {t} after reset", pack_outputs(slam.last_output))
    return recs


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.is_floating_point():
        return a.shape == b.shape and torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def test_graph_step_equals_the_eager_step_through_facade_calls(world, stand_in, tmp_path):
    d, frames, rs, qs, cfg = world
    eager = _script(MonoSLAM(cfg, device="cpu", **OVERRIDES),
                    lambda s, f, m: s._go_one_step_eager(f, True, m), frames, rs, qs, str(tmp_path))
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    graph = _script(slam, lambda s, f, m: s._go_one_step_graph(f, True, m), frames, rs, qs, str(tmp_path))
    assert [r[0] for r in graph] == [r[0] for r in eager]
    for (tag, grow, gstate), (_t, erow, estate) in zip(graph, eager):
        if erow is not None:
            assert _same_bits(grow, erow), tag
        for name, g, e in zip(slam.state._fields, gstate, estate):
            assert _same_bits(g, e), (tag, name)
    # one one-step graph for each enable_mapping value
    assert sorted((k[1], k[2]) for k in slam._graphs) == [(False, 1), (True, 1)]
    # the script did change the map between calls
    tags = dict((t, s) for t, _r, s in eager)
    assert int(tags["initialise_feature"][2].sum()) == int(tags["step 10"][2].sum()) + 1


def test_one_step_graph_is_run_sequences_and_fits_the_cache(world, stand_in):
    d, frames, rs, qs, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    seq = slam._to_device(frames[1:12])               # 8 + 3: the block graph and the one-step graph
    flat = torch.empty((seq.shape[0], pack_outputs(_first_out(slam, frames)).shape[0]))
    slam.reset()
    for mapping in (True, False):
        replay.replay_steps(slam._step, slam._graphs, slam.state, seq, mapping, 0, flat)
    keys = set(slam._graphs)
    assert len(keys) == 4 == replay.MAX_GRAPHS
    for t in range(12, 22):                            # mapping off and on alternately
        slam._go_one_step_graph(frames[t], True, t % 2 == 0)
        assert set(slam._graphs) == keys                # the same graphs: nothing captured, nothing dropped


def _first_out(slam, frames):
    slam._go_one_step_eager(frames[1], False, True)
    return slam.last_output


def test_a_held_state_does_not_change_under_later_replays(world, stand_in):
    d, frames, rs, qs, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam._go_one_step_graph(frames[1], True, True)
    held = slam.state
    kept = tuple(t.clone() for t in held)
    for t in range(2, 5):
        slam._go_one_step_graph(frames[t], True, True)
    for a, b in zip(held, kept):
        assert _same_bits(a, b)
    (g,) = slam._graphs.values()
    for a, b in zip(slam.state, g.state_in):
        assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert len(slam.trajectory()) == 4
