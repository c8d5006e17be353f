"""The single stream's split route (D > 384) against the benchmark's
reference (perfbench/reference/, NumPy f64) on the room walk, on the CPU.

The stream is the first frames of room900-replay (the hand-held walk onto
fresh ground, textures rendered on the CPU), run through
MonoSLAM.run_sequence under the mf100 configuration
(perfbench/configs/mf100.json: 100 slots, D = 613) and at the smallest
split size, 62 slots (D = 385). The pose is held to the mf100-room limit
(perfbench/limits/mf100-room.json) by the benchmark's comparison
(perfbench/compare.py), and every frame's decisions (visible, selected and
matched counts, the map's size, its partial features, a proposal, a
conversion) must equal the reference's. A covariance perturbed after the
update must read not correct.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np
import pytest
import torch

from perfbench import compare, harness, systems
from perfbench.reference.replay import replay_many
from scenelib2_torch.core import ekf

SEED = 2 ** 31 + 77             # a seed beyond 32 signed bits, as the benchmark's tests use
FRAMES = 100

def _json(*parts):
    with open(os.path.join(harness.HERE, *parts)) as f:
        return json.load(f)


CONFIG = _json("configs", "mf100.json")
TRAFFIC = _json("traffic", "room900-replay.json")
LIMITS = _json("limits", "mf100-room.json")["limits"]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def run(max_features: int, frames: int, tmp_path) -> tuple[systems.SingleStream, dict, np.ndarray, dict]:
    """One pass of the cell's stream cut to `frames` frames at `max_features`
    slots, and the reference over it: (the system, the comparison's numbers,
    the pass's decisions, the reference's record)."""
    config = copy.deepcopy(CONFIG)
    config["settings"]["max_features"] = max_features
    system = systems.SingleStream(config, dict(TRAFFIC, frames=frames), SEED, "cpu", str(tmp_path))
    system.run_pass()
    pose, dec = system.records()
    (ref,) = replay_many(system.reference_jobs(), 1)
    return system, compare.numbers(pose, dec, [ref], LIMITS["pose_gap_median"]), dec[0], ref


@pytest.mark.parametrize("max_features,D", [(100, 613), (62, 385)])
def test_split_route_holds_the_reference_on_the_room_walk(max_features, D, tmp_path):
    system, got, dec, ref = run(max_features, FRAMES, tmp_path)
    assert system.slam._step.route == "split" and system.slam.state.x.shape[-1] == D
    assert got["pose_gap_median"] <= LIMITS["pose_gap_median"] and got["frames_failed"] == 0, got
    off = np.flatnonzero(np.any(dec != ref["decisions"], axis=1)).tolist()
    assert off == [], (off, got)
    assert dec[:, 3].max() > 4                         # the map grew past the known features


def test_covariance_perturbed_after_the_update_is_not_correct(tmp_path, monkeypatch):
    """P scaled by 1.1 after each update's normalisation: the gains, the
    search windows and the pose drift from the reference's."""
    normalise = ekf.normalise

    def perturbed(x, P):
        x, P = normalise(x, P)
        return x, P * 1.1

    monkeypatch.setattr(ekf, "normalise", perturbed)
    _system, got, _dec, _ref = run(62, 40, tmp_path)
    ok, shown = compare.verdict(got, LIMITS)
    assert not ok, shown
