"""run_sequence(chunk=) and run_batch(chunk=), and the step's purity that
the CUDA-graph replay relies on (scenelib2_torch/runtime/replay.py).

On the CPU both entry points call the step on every frame, and chunk only
groups the frames (on the card each group is one CUDA graph):

  (a) the port's run_sequence(chunk=5) over 12 std frames with mapping on
      (two chunks and a remainder of 2) against the JAX package's
      MonoSLAM.run_sequence(..., chunk=5), its compiled scan of 5 steps and
      its single-step jit, f32 with use_pallas=True in a subprocess as in
      tests/test_torch_step_jax.py: decisions, selection sets, the init box
      and the particle masks identical, r and xv within 1e-4;
  (b) the port's run_sequence and run_batch at several chunk sizes against
      chunk = 0, bit for bit, and chunk_plan's groups;
  (c) one step leaves every field of its input state unchanged (the graph's
      warm-up step runs on the static inputs before the capture), on the
      single stream's fused, split and pure-XLA routes and on each batch
      route;
  (d) replay_steps' bookkeeping, with a stand-in for the CUDA graph that
      calls the captured steps eagerly at replay (StepGraph's own replay and
      final-state handover kept): the groups, the handover of the state
      between graphs and replays, the copy it returns, the packed rows and
      the bound on the graphs a cache keeps, against the eager loop bit for
      bit; the pure-XLA single stream likewise.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM
from scenelib2_torch.eval.batch import make_lanes
from scenelib2_torch.eval.fingerprint import DECISION_FIELDS, selection_set
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.parallel.mesh import _run_batch_eager, make_batched_step, run_batch
from scenelib2_torch.runtime import replay, telemetry
from scenelib2_torch.runtime.replay import MAX_GRAPHS, REPLAY_BLOCK, chunk_plan
from scenelib2_torch.runtime.state import SlamState
from scenelib2_torch.runtime.step import pack_outputs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12
CHUNK = 5
STEP_TOL = 1e-4
EXACT_FIELDS = ("init_box", "par_slot", "par_mask", "par_alive")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def std(tmp_path_factory):
    """(frames, cfg path) of the std synthetic sequence, N_FRAMES + 1 frames."""
    frames, _r, _q, cfg = generate_dataset(str(tmp_path_factory.mktemp("std")), n_frames=N_FRAMES + 1)
    return frames, cfg


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (floats as their bit patterns: NaN equals NaN)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {torch.float32: torch.int32, torch.float64: torch.int64}[a.dtype]
        return torch.equal(a.view(view), b.view(view))
    return torch.equal(a, b)


def _same_outputs(a, b) -> bool:
    return all(_same_bits(x, y) for x, y in zip(a, b))


_JAX_RUNNER = r"""
import os, sys
os.environ['SCENELIB2_X64'] = '0'
os.environ['JAX_PLATFORMS'] = 'cpu'
import jax
jax.config.update('jax_platforms', 'cpu')
import numpy as np
from scenelib2_tpu.eval.synthetic import generate_dataset
from scenelib2_tpu.runtime.slam import MonoSLAM

out_dir, n, chunk = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
frames, _, _, cfg = generate_dataset(out_dir, n_frames=n + 1)
slam = MonoSLAM(cfg, max_features=16, use_pallas=True)
outs = slam.run_sequence(frames[1:], enable_mapping=True, chunk=chunk)
np.savez(os.path.join(out_dir, 'jax_outs.npz'), frames=frames,
         **{k: np.asarray(v) for k, v in outs._asdict().items()})
"""


def test_run_sequence_chunk_matches_jax(tmp_path):
    assert chunk_plan(N_FRAMES, CHUNK) == [CHUNK, CHUNK, 1, 1]
    env = {k: v for k, v in os.environ.items() if k != "JAX_ENABLE_X64"}
    env["PYTHONPATH"] = REPO
    env["XLA_FLAGS"] = (env.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false"
                        " intra_op_parallelism_threads=1").strip()
    res = subprocess.run([sys.executable, "-c", _JAX_RUNNER, str(tmp_path), str(N_FRAMES), str(CHUNK)],
                         capture_output=True, text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr[-3000:]
    with np.load(tmp_path / "jax_outs.npz") as z:
        want = {k: z[k] for k in z.files}
    slam = MonoSLAM(str(tmp_path / "synthetic.cfg"), max_features=16, device="cpu")
    got = slam.run_sequence(want["frames"][1:], enable_mapping=True, chunk=CHUNK)
    assert got.r.shape == (N_FRAMES, 3)
    for name in DECISION_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=name)
    np.testing.assert_array_equal(selection_set(got), selection_set(SimpleNamespace(**want)))
    for name in EXACT_FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy().astype(np.int64),
                                      want[name].astype(np.int64), err_msg=name)
    for k in ("r", "xv"):
        np.testing.assert_allclose(getattr(got, k).numpy(), want[k], rtol=0, atol=STEP_TOL, err_msg=k)


@pytest.mark.parametrize("n, chunk, groups", [
    (12, 0, [REPLAY_BLOCK] * (12 // REPLAY_BLOCK) + [1] * (12 % REPLAY_BLOCK)), (12, 5, [5, 5, 1, 1]),
    (12, 1, [1] * 12), (12, 12, [12]), (12, 13, [1] * 12), (239, 64, [64, 64, 64] + [1] * 47), (0, 5, []),
    (40, 0, [REPLAY_BLOCK] * (40 // REPLAY_BLOCK) + [1] * (40 % REPLAY_BLOCK)), (0, 0, []),
])
def test_chunk_plan(n, chunk, groups):
    assert chunk_plan(n, chunk) == groups
    assert sum(groups) == n


@pytest.mark.parametrize("chunk", [-1, 2.0, True])
def test_chunk_refused(std, chunk):
    frames, cfg = std
    with pytest.raises(ValueError):
        MonoSLAM(cfg, max_features=16, device="cpu").run_sequence(frames[1:3], chunk=chunk)


@pytest.fixture(scope="module")
def chunk0(std):
    """The reference: run_sequence(chunk=0) over the std frames, mapping on,
    and its final state."""
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    return slam.run_sequence(frames[1:], enable_mapping=True), slam.state


@pytest.mark.parametrize("chunk", [1, 5, 12, 13])
def test_run_sequence_chunks_bit_for_bit(std, chunk0, chunk):
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    outs = slam.run_sequence(frames[1:], enable_mapping=True, chunk=chunk)
    assert _same_outputs(outs, chunk0[0])
    assert _same_outputs(slam.state, chunk0[1])
    assert _same_outputs(slam.last_output, type(outs)(*(a[-1] for a in chunk0[0])))


def test_run_sequence_eager_helper_equals(std, chunk0):
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    assert _same_outputs(slam._run_sequence_eager(frames[1:], enable_mapping=True), chunk0[0])
    assert _same_outputs(slam.state, chunk0[1])


@pytest.fixture(scope="module")
def two_lanes(tmp_path_factory):
    """(params, states_b, frames [T, 2, H, W]) of lanes 0 and 1 of the
    bench_batch64 recipe, 11 frames a lane."""
    return make_lanes(str(tmp_path_factory.mktemp("lanes")), 64, 32, 12, device="cpu",
                      dtype=torch.float32, lanes=[0, 1])


@pytest.mark.parametrize("chunk", [1, 3, 11])
def test_run_batch_chunks_bit_for_bit(two_lanes, chunk):
    params, states, frames = two_lanes
    step = make_batched_step(params, device="cpu")
    want_state, want = _run_batch_eager(step, states, frames, True, params)
    got_state, got = run_batch(step, states, frames, True, params, chunk=chunk)
    assert _same_outputs(got, want)
    assert _same_outputs(got_state, want_state)
    assert int(want.did_init.sum()) > 0


def _assert_unchanged(step, state, frame, enable_mapping=True):
    before = SlamState(*(t.clone() for t in state))
    step(state, frame, enable_mapping)
    for name, a, b in zip(SlamState._fields, state, before):
        assert _same_bits(a, b), f"the step changed its input state's field {name}"


@pytest.mark.parametrize("max_features, route", [(16, "fused"), (100, "split"), (16, "xla")])
def test_step_leaves_its_input_state_unchanged(std, max_features, route):
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=max_features, device="cpu", use_pallas=route != "xla")
    assert slam._step.route == route
    slam.run_sequence(frames[1:N_FRAMES])
    assert int(slam.last_output.n_partial) > 0       # the surgery's fields are live
    for mapping in (True, False):
        _assert_unchanged(slam._step, slam.state, slam._to_device(frames[N_FRAMES]), mapping)


@pytest.mark.parametrize("route", ["default", "sb0", "bp0", "xla"])
def test_batch_step_leaves_its_input_state_unchanged(two_lanes, route):
    params, states, frames = two_lanes
    if route == "bp0":
        params = dataclasses.replace(params, batch_pallas=False)
    elif route == "xla":
        params = dataclasses.replace(params, use_pallas=False)
    step = make_batched_step(params, device="cpu", batch_sb=route != "sb0")
    assert step.route == route
    states, outs = run_batch(step, states, frames[:-1], True, params)
    assert bool((outs.n_partial[-1] > 0).all())
    for mapping in (True, False):
        _assert_unchanged(step, states, torch.as_tensor(frames[-1]), mapping)


class _EagerStepGraph(replay.StepGraph):
    """replay.StepGraph with its capture replaced by a stand-in that runs on
    the CPU: the N steps are called at each replay, on the static inputs,
    and end in StepGraph._keep as the captured graph does. Its
    telemetry.GraphRecord counts replays and no nodes."""

    def __init__(self, step, state, frames, enable_mapping, pool=None):
        self.n = frames.shape[0]
        self.record = telemetry.GraphRecord(step.route, enable_mapping, self.n)
        self.state_in = SlamState(*(t.clone() for t in state))
        self.frames = frames.clone()

        def run():
            s, packed = self.state_in, []
            for i in range(self.n):
                s, out = step(s, self.frames[i], enable_mapping)
                packed.append(pack_outputs(out))
            self.flat = torch.stack(packed)
            self._keep(s)

        self.graph = SimpleNamespace(replay=run, pool=lambda: pool or (id(self),))
        self.pool = pool


def _replay_cpu(monkeypatch, slam, seq, chunk, graphs):
    monkeypatch.setattr(replay, "StepGraph", _EagerStepGraph)
    monkeypatch.setattr(replay, "sync_error", contextlib.nullcontext)
    flat = torch.empty((seq.shape[0], replay_flat_width(slam)), dtype=slam.dtype)
    state = replay.replay_steps(slam._step, graphs, slam.state, seq, True, chunk, flat)
    return state, flat


def replay_flat_width(slam) -> int:
    from scenelib2_torch.runtime.step import packed_size

    p = slam.params
    return packed_size(p.n_features_to_select, max(1, p.max_features_to_init_at_once), p.n_particles)


@pytest.fixture(scope="module")
def eager_flat(std):
    """The eager loop's packed rows and final state over the std frames."""
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    seq = slam._to_device(frames[1:])
    flat = torch.empty((seq.shape[0], replay_flat_width(slam)), dtype=slam.dtype)
    state = replay.eager_steps(slam._step, slam.state, seq, True, flat)
    return flat, state


@pytest.mark.parametrize("chunk", [0, 4, 5])
def test_replay_steps_with_a_stand_in_graph(std, eager_flat, monkeypatch, chunk):
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    seq = slam._to_device(frames[1:])
    graphs = {}
    state, flat = _replay_cpu(monkeypatch, slam, seq, chunk, graphs)
    assert _same_bits(flat, eager_flat[0])
    assert _same_outputs(state, eager_flat[1])
    assert sorted(k[2] for k in graphs) == sorted(set(chunk_plan(seq.shape[0], chunk)))
    # the graphs after the first take the first one's pool
    first, *rest = graphs.values()
    assert first.pool is None and all(g.pool == first.graph.pool() for g in rest)
    # the state returned is a copy, not a graph's static inputs
    for g in graphs.values():
        for a, b in zip(state, g.state_in):
            assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    # the same graphs replay again from the initial state, and give the same rows
    state2, flat2 = _replay_cpu(monkeypatch, slam, seq, chunk, graphs)
    assert _same_bits(flat2, eager_flat[0]) and _same_outputs(state2, eager_flat[1])


@pytest.mark.parametrize("chunk", [0, 5])
def test_xla_route_replays_through_a_stand_in_graph(std, monkeypatch, chunk):
    """The pure-XLA single stream through replay_steps' graphs (the
    stand-in) equals its eager loop bit for bit, rows and final state."""
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu", use_pallas=False)
    seq = slam._to_device(frames[1:])
    want = torch.empty((seq.shape[0], replay_flat_width(slam)), dtype=slam.dtype)
    want_state = replay.eager_steps(slam._step, slam.state, seq, True, want)
    graphs = {}
    state, flat = _replay_cpu(monkeypatch, slam, seq, chunk, graphs)
    assert _same_bits(flat, want) and _same_outputs(state, want_state)
    assert {k[0] for k in graphs} == {"xla"}


def test_graph_cache_is_bounded(std, eager_flat, monkeypatch):
    frames, cfg = std
    slam = MonoSLAM(cfg, max_features=16, device="cpu")
    seq = slam._to_device(frames[1:])
    graphs = {}
    for chunk in (2, 3, 4, 5, 6, 2):
        state, flat = _replay_cpu(monkeypatch, slam, seq, chunk, graphs)
        assert len(graphs) <= MAX_GRAPHS
        assert chunk in [k[2] for k in graphs]        # the graphs just used are kept
        assert _same_bits(flat, eager_flat[0]) and _same_outputs(state, eager_flat[1])


def test_keep_copies_the_final_state_into_the_inputs():
    """StepGraph._keep with a field passed through unchanged, a field that is
    a view of another input's memory and fresh fields."""
    g = object.__new__(replay.StepGraph)
    n = len(SlamState._fields)
    g.state_in = SlamState(*(torch.arange(4, dtype=torch.float32) + 10 * i for i in range(n)))
    want = [torch.arange(4, dtype=torch.float32) * -1 - 10 * i for i in range(n)]
    final = list(want)
    final[0] = g.state_in[0]                          # passed through
    final[2] = g.state_in[1].flip(0)                  # the view of input 1 that input 2 takes ...
    final[1] = g.state_in[2] * 0 + 7                  # ... while input 1 is overwritten
    want[0], want[2], want[1] = g.state_in[0].clone(), g.state_in[1].flip(0).clone(), torch.full((4,), 7.0)
    g._keep(SlamState(*final))
    for name, a, b in zip(SlamState._fields, g.state_in, want):
        assert torch.equal(a, b), name
    with pytest.raises(RuntimeError, match="changed state field"):
        g._keep(SlamState(*([torch.zeros(5)] * n)))
