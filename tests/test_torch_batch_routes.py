"""The batch step's routes: which flags select which route, that the
port's entry points build the kernel route (use_pallas=True) by default,
and the first lanes of each route's committed fingerprints on the CPU.

Routes (runtime.step.batch_route, as the JAX step selects them): "default"
(batch_pallas=True), "sb0" (batch_pallas=True with the search + Bayes pair,
SCENELIB2_BATCH_SB=0 or batch_sb=False) and "bp0" (batch_pallas=False).
Each runs its own wrappers (kernels/_build.py launch counts on the CPU stay
0, so the test watches the wrappers the step calls). The fingerprint check
replays lanes 0-3 x 63 frames of the bench_batch64 recipe (one texture
each, ~25 s for sb0 and ~60 s for bp0 on one core) against the committed
file, which every JAX route reproduces (eval.batch.check_lanes).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params, load_config
from scenelib2_torch.eval.batch import check_lanes, lane_fingerprints, make_lanes
from scenelib2_torch.parallel.mesh import make_batched_step, run_batch
from scenelib2_torch.runtime.step import batch_route

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = (0, 1, 2, 3)
# the wrappers of stages 2, 3, 7 and 8 that each route calls (and no other)
ROUTE_WRAPPERS = {
    "default": {"measure_select", "search", "shi_tomasi", "score_map", "particle_predict",
                "search_bayes_maps"},
    "sb0": {"measure_select", "search", "shi_tomasi", "score_map", "particle_predict",
            "particle_search", "bayes_update"},
    "bp0": {"search_windows", "shi_tomasi_plain", "bayes_update"},
}
ALL_WRAPPERS = set().union(*ROUTE_WRAPPERS.values())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _calls(seen: set):
    import scenelib2_torch.runtime.step as step_mod

    orig = {n: getattr(step_mod, n) for n in ALL_WRAPPERS}

    def wrap(n):
        def call(*a, **k):
            seen.add(n)
            return orig[n](*a, **k)
        return call

    for n in ALL_WRAPPERS:
        setattr(step_mod, n, wrap(n))
    try:
        yield
    finally:
        for n in ALL_WRAPPERS:
            setattr(step_mod, n, orig[n])


def test_flags_select_the_jax_route(monkeypatch):
    p = Params()
    monkeypatch.delenv("SCENELIB2_BATCH_SB", raising=False)
    assert batch_route(p) == "default"
    assert batch_route(p, batch_sb=False) == "sb0"
    assert batch_route(dataclasses.replace(p, batch_pallas=False)) == "bp0"
    assert batch_route(dataclasses.replace(p, batch_pallas=False), batch_sb=True) == "bp0"
    monkeypatch.setenv("SCENELIB2_BATCH_SB", "0")
    assert batch_route(p) == "sb0"
    assert batch_route(p, batch_sb=True) == "default"
    monkeypatch.setenv("SCENELIB2_BATCH_SB", "1")
    assert batch_route(p) == "default"


def test_entry_points_build_the_kernel_route(tmp_path):
    """use_pallas=True (the JAX kernel route) is the port's default: the
    config reader, the facade and the batch lanes all carry it."""
    assert Params().use_pallas
    cfg = os.path.join(REPO, "data", "SceneLib2.cfg")
    assert load_config(cfg).params.use_pallas
    assert MonoSLAM(cfg, device="cpu").params.use_pallas
    params, _states, _frames = make_lanes(str(tmp_path), n_frames=3, device="cpu",
                                          dtype=torch.float32, lanes=[0])
    assert params.use_pallas and params.batch_mode and params.batch_pallas


@pytest.mark.parametrize("route", ["sb0", "bp0"])
def test_route_reproduces_first_lanes_of_its_committed_file(route, tmp_path):
    params, states, frames = make_lanes(str(tmp_path), device="cpu", dtype=torch.float32, lanes=LANES)
    if route == "bp0":
        params = dataclasses.replace(params, batch_pallas=False)
    seen = set()
    with _calls(seen):
        step = make_batched_step(params, device="cpu", batch_sb=False if route == "sb0" else None)
        _final, outs = run_batch(step, states, frames, True, params)
    assert seen == ROUTE_WRAPPERS[route]
    assert check_lanes(lane_fingerprints(outs), LANES, route=route) == []
