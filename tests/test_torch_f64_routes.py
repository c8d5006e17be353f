"""How the port maps precision="f64" onto JAX's routes, and the entry points
that stand for JAX's parity process.

The port keeps JAX's flag semantics: in f64 only stage 3 follows the flags,
so use_pallas=False is the parity route "xla-f64" (no kernel) and
use_pallas=True JAX's hybrid route, K2 on the single stream and on
batch_pallas lanes ("k2-f64"), K8 with batch_pallas=False ("k8-f64");
batch_sb and SCENELIB2_BATCH_SB pick between stage-8 kernels only, so in
f64 they change nothing. The port's Params keep use_pallas=True, so
MonoSLAM(cfg, precision="f64") alone is the hybrid route, and `cli run` /
`print-state --precision f64` pass use_pallas=False: JAX's parity process.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from scenelib2_torch import MonoSLAM, cli
from scenelib2_torch.config import Params
from scenelib2_torch.eval.synthetic import generate_dataset
from scenelib2_torch.io.pgm import write_pgm
from scenelib2_torch.parallel.mesh import make_batched_step
from scenelib2_torch.runtime.step import make_batch_step, make_step

P = Params()
N_CLI = 10
# (precision, use_pallas) -> the single stream's route
SINGLE = {("f32", True): "fused", ("f32", False): "xla", ("f64", True): "k2-f64", ("f64", False): "xla-f64"}
# (precision, use_pallas, batch_pallas, batch_sb) -> the batch route
BATCH = {
    ("f32", True, True, None): "default", ("f32", True, True, False): "sb0",
    ("f32", True, False, None): "bp0", ("f32", False, True, None): "xla", ("f32", False, False, None): "xla",
    ("f64", True, True, None): "k2-f64", ("f64", True, True, False): "k2-f64",
    ("f64", True, False, None): "k8-f64", ("f64", True, False, False): "k8-f64",
    ("f64", False, True, None): "xla-f64", ("f64", False, False, None): "xla-f64",
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("flags", list(SINGLE), ids=[f"{p}-pallas{u}" for p, u in SINGLE])
def test_single_stream_route_of_each_flag_combination(flags):
    precision, use_pallas = flags
    step = make_step(dataclasses.replace(P, use_pallas=use_pallas), device="cpu", precision=precision)
    assert step.route == SINGLE[flags]


@pytest.mark.parametrize("flags", list(BATCH), ids=["-".join(map(str, f)) for f in BATCH])
def test_batch_route_of_each_flag_combination(flags, monkeypatch):
    precision, use_pallas, batch_pallas, batch_sb = flags
    monkeypatch.delenv("SCENELIB2_BATCH_SB", raising=False)
    p = dataclasses.replace(P, use_pallas=use_pallas, batch_pallas=batch_pallas, batch_mode=True)
    assert make_batch_step(p, device="cpu", precision=precision, batch_sb=batch_sb).route == BATCH[flags]
    assert make_batched_step(p, device="cpu", batch_sb=batch_sb, precision=precision).route == BATCH[flags]
    if precision == "f64":                # the environment's stage-8 switch changes nothing in f64
        monkeypatch.setenv("SCENELIB2_BATCH_SB", "0")
        assert make_batched_step(p, device="cpu", precision=precision).route == BATCH[flags]


def test_f64_alone_is_the_hybrid_route_and_takes_any_map_size():
    """MonoSLAM(cfg, precision="f64") keeps the port's use_pallas=True: JAX's
    hybrid route. The f64 step launches no slot-row kernel, so it takes
    more than 128 slots, as JAX's x64 step does; f32 refuses them."""
    cfg = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data", "SceneLib2.cfg")
    slam = MonoSLAM(cfg, device="cpu", precision="f64")
    assert slam.params.use_pallas is True and slam._step.route == "k2-f64"
    assert slam.state.x.dtype == torch.float64
    big = dataclasses.replace(P, max_features=130)
    for use_pallas, route in ((False, "xla-f64"), (True, "k2-f64")):
        assert make_step(dataclasses.replace(big, use_pallas=use_pallas), device="cpu",
                         precision="f64").route == route
    with pytest.raises(NotImplementedError, match="max_features = 130"):
        make_step(big, device="cpu")


def test_cli_run_and_print_state_f64_are_the_parity_process(tmp_path, capsys):
    frames, _, _, cfg = generate_dataset(str(tmp_path / "ds"), n_frames=N_CLI)
    seq = tmp_path / "seq"
    seq.mkdir()
    for i, f in enumerate(frames):
        write_pgm(str(seq / f"frame_{i:04d}.pgm"), f)
    out = tmp_path / "run"
    cli.main(["run", "--config", cfg, "--seq", str(seq), "--out", str(out), "--mapping", "--checkpoint",
              "--cpu", "--precision", "f64"])
    capsys.readouterr()
    rows = [json.loads(line) for line in open(out / "metrics.jsonl")]
    ref = MonoSLAM(cfg, device="cpu", precision="f64", use_pallas=False, max_features=16)
    assert ref._step.route == "xla-f64"
    for rec, frame in zip(rows, frames[1:]):          # run skips the first frame
        ref.go_one_step(frame)
        o = ref.last_output
        assert [rec[k] for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial")] == \
            [int(getattr(o, k)) for k in ("n_visible", "n_selected", "n_matched", "n_active", "n_partial")]
        assert (rec["did_init"], rec["did_convert"]) == (bool(o.did_init), bool(o.did_convert))
    assert len(rows) == N_CLI - 1
    np.testing.assert_array_equal(np.load(out / "trajectory.npz")["r"], ref.trajectory())
    with np.load(out / "final_state.npz") as z:
        assert z["state_x"].dtype == np.float64
        np.testing.assert_array_equal(z["state_x"], ref.state.x.numpy())
    cli.main(["print-state", "--config", cfg, "--checkpoint", str(out / "final_state.npz"), "--cpu",
              "--precision", "f64"])
    printed = capsys.readouterr().out
    assert "[Robot state]" in printed and f"{float(ref.state.x[0]):.4f}"[:5] in printed


@pytest.mark.parametrize("chunk", [0, 5])
def test_f64_replay_through_a_stand_in_graph_keyed_by_dtype(tmp_path, monkeypatch, chunk):
    """The f64 parity route through replay_steps' graphs (the CPU stand-in
    of tests/test_torch_replay.py) equals its eager loop bit for bit, and
    the graph cache keys its graphs by the state's dtypes too: an f32 state
    of the same shapes under the same route name gets graphs of its own."""
    from scenelib2_torch.runtime import replay
    from tests.test_torch_replay import _EagerStepGraph, _replay_cpu, _same_bits, _same_outputs, replay_flat_width

    frames, _, _, cfg = generate_dataset(str(tmp_path / "ds"), n_frames=13)
    slam = MonoSLAM(cfg, device="cpu", precision="f64", use_pallas=False, max_features=16)
    seq = slam._to_device(frames[1:])
    want = torch.empty((seq.shape[0], replay_flat_width(slam)), dtype=torch.float64)
    want_state = replay.eager_steps(slam._step, slam.state, seq, True, want)
    graphs = {}
    state, flat = _replay_cpu(monkeypatch, slam, seq, chunk, graphs)
    assert _same_bits(flat, want) and _same_outputs(state, want_state)
    assert {k[0] for k in graphs} == {"xla-f64"}
    assert all(dict(k[3])[tuple(state.x.shape)] == torch.float64 for k in graphs)
    f32 = MonoSLAM(cfg, device="cpu", use_pallas=False, max_features=16)
    f32._step.route = "xla-f64"          # the same name: only the dtypes tell the graphs apart
    n = len(graphs)
    assert n == 2 and any(k[2] == 1 for k in graphs)     # the block graph and the one-step graph
    g = replay.cached_graph(f32._step, graphs, f32.state, seq[:1], True)
    assert len(graphs) == n + 1 and g.state_in.x.dtype == torch.float32
