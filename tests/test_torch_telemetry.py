"""The spans and counters of the facade and the graph replay, and the
stage marks of the step (scenelib2_torch/runtime/telemetry.py).

On the CPU the step runs eagerly; the graph path runs with the stand-in
graph of tests/test_torch_replay.py (its steps called at each replay), so
that every span and counter of the graph path is reached. The `chip` test
needs a card (it skips without one): there the 8-step graph's kernels by
stage are counted from its capture, and no span reaches the device's
timeline. Run it on a card with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_telemetry.py -m chip
"""

from __future__ import annotations

import contextlib
import time
import types

import pytest
import torch

from torch.utils._python_dispatch import TorchDispatchMode

from scenelib2_torch import MonoSLAM
from scenelib2_torch.config import Params
from scenelib2_torch.runtime import replay, telemetry
from scenelib2_torch.runtime.state import SlamState
from tests.test_torch_replay import _EagerStepGraph

OVERRIDES = dict(max_features=8, n_particles=16, n_features_to_select=4, n_features_to_keep_visible=6,
                 min_particles=4, init_search_width=24, init_search_height=18, feature_separation_min=5)
SMALL = dict(cam_width=160, cam_height=120, cam_fku=98.0, cam_fkv=98.0, cam_u0=80.0, cam_v0=60.0, **OVERRIDES)
CALL_SPANS = ("slam.upload", "slam.copy_in", "slam.launch", "slam.copy_out", "slam.unpack", "slam.fetch",
              "slam.capture", "slam.step")
ENTRY_SPANS = ("slam.go_one_step", "slam.run_sequence")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from scenelib2_torch.eval.synthetic import generate_dataset

    d = tmp_path_factory.mktemp("telemetry")
    frames, _rs, _qs, cfg = generate_dataset(str(d), n_frames=56, params=Params(**SMALL))
    return frames, cfg


@pytest.fixture
def graph_path(monkeypatch):
    """On the CPU, go_one_step and run_sequence through the graph path, a
    stand-in graph replaying the captured steps eagerly."""
    monkeypatch.setattr(replay, "StepGraph", _EagerStepGraph)
    monkeypatch.setattr(replay, "sync_error", contextlib.nullcontext)

    def through_graphs(slam):
        monkeypatch.setattr(slam, "_go_one_step_eager", slam._go_one_step_graph)
        monkeypatch.setattr(slam, "_replay", lambda frames, mapping, chunk, graphs: MonoSLAM._replay(
            slam, frames, mapping, chunk, graphs=True))
        return slam

    return through_graphs


def _parts_us(rec) -> dict:
    """A call's five parts, microseconds a call."""
    n = rec.n["call"]
    parts = {p: rec.ns[p] / n / 1e3 for p in ("upload", "copies", "launch", "wait")}
    parts["other"] = rec.ns["call"] / n / 1e3 - sum(parts.values())
    return parts


def test_construction_and_reset_start_a_new_record(world):
    frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    first = slam.counters
    assert telemetry.latest() is first and first.n["call"] == 0
    for t in range(1, 4):
        slam.go_one_step(frames[t])
    assert first.n["call"] == 3 == first.frames
    slam.reset()
    assert slam.counters is not first and telemetry.latest() is slam.counters
    assert slam.counters.n == dict.fromkeys(telemetry.PARTS, 0) and slam.counters.frames == 0
    slam.go_one_step(frames[1])
    assert (first.n["call"], slam.counters.n["call"]) == (3, 1)
    slam.run_sequence(frames[1:6])
    assert slam.counters.frames == 6 and slam.counters.n["sequence"] == 1


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_a_calls_parts_are_non_negative_and_sum_to_its_wall(world, graph_path, path):
    frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    if path == "graph":
        graph_path(slam)
    for t in range(1, 11):
        slam.go_one_step(frames[t], enable_mapping=t % 3 != 0)
    rec = slam.counters
    parts = _parts_us(rec)
    assert all(v >= 0 for v in parts.values()), parts
    assert sum(parts.values()) == pytest.approx(rec.ns["call"] / 10 / 1e3)
    assert (rec.n["upload"], rec.n["launch"], rec.n["wait"]) == (10, 10, 10)
    # eagerly the step is the launch and nothing is copied; through a graph
    # each call copies in and out, and launches the one-step graph
    assert rec.n["copies"] == (20 if path == "graph" else 0)
    assert {k: c for k, (_ns, c) in rec.launches.items()} == {1: 10}
    assert parts["launch"] > 0 and parts["wait"] > 0 and parts["upload"] > 0


def test_the_counted_wall_agrees_with_an_outside_timer(world):
    frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam.go_one_step(frames[1])
    slam.reset()
    outside = 0
    for t in range(1, 51):
        t0 = time.perf_counter_ns()
        slam.go_one_step(frames[t])
        outside += time.perf_counter_ns() - t0
    assert slam.counters.n["call"] == 50
    assert slam.counters.ns["call"] == pytest.approx(outside, rel=0.05)
    assert slam.counters.ns["call"] <= outside


def test_spans_under_a_cpu_profiler(world, graph_path):
    from torch.profiler import ProfilerActivity, profile

    frames, cfg = world
    eager = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    slam = graph_path(MonoSLAM(cfg, device="cpu", **OVERRIDES))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eager.go_one_step(frames[1])                   # the step called: slam.step
        slam.reset()
        for t in range(1, 4):                          # the first call captures the one-step graph
            slam.go_one_step(frames[t])
        slam.run_sequence(frames[4:14], chunk=4)       # 4 + 4 + 1 + 1
    assert slam.counters.profiled and eager.counters.profiled
    assert telemetry.latest() not in (slam.counters, eager.counters)     # profiled: the profiler's times
    events = [e for e in prof.events() if e.name.startswith("slam.")]
    names = {e.name for e in events}
    assert names >= set(CALL_SPANS + ENTRY_SPANS) | {"slam.reset"}, names
    for e in events:
        assert e.scope == 0, (e.name, e.scope)          # FUNCTION, never USER (7)
        if e.name in CALL_SPANS:
            parent = e.cpu_parent
            while parent is not None and parent.name not in ENTRY_SPANS:
                parent = parent.cpu_parent
            assert parent is not None, e.name
    by = {n: sum(e.name == n for e in events) for n in names}
    assert by["slam.go_one_step"] == 3 + 1 and by["slam.run_sequence"] == 1
    assert by["slam.launch"] == 3 + 4 and by["slam.fetch"] == 1 + 3 + 1 and by["slam.step"] == 1
    assert by["slam.capture"] == 2                     # the one-step and the 4-step graphs


def test_no_span_is_recorded_without_a_profiler(world, graph_path, monkeypatch):
    made = []

    class Counted:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return None

        def __exit__(self, *exc):
            return None

    frames, cfg = world
    slam = graph_path(MonoSLAM(cfg, device="cpu", **OVERRIDES))
    monkeypatch.setattr(telemetry, "_RecordFunction", Counted)
    for t in range(1, 4):
        slam.go_one_step(frames[t])
    slam.run_sequence(frames[4:10])
    slam.reset()
    assert made == [] and not slam.counters.profiled
    assert telemetry.span("slam.step") is telemetry._OFF


def test_stage_marks_do_nothing_outside_a_capture(world, monkeypatch):
    frames, cfg = world

    def driver():
        raise AssertionError("a mark outside a capture asked the driver")

    tally = telemetry.StageTally()
    slam = MonoSLAM(cfg, device="cpu", **OVERRIDES)
    telemetry.stage("s3")                              # no capture open
    monkeypatch.setattr(telemetry, "_driver", driver)
    monkeypatch.setattr(telemetry, "_capture", tally)
    slam.go_one_step(frames[1])                        # every mark of the fused route, eagerly
    MonoSLAM(cfg, device="cpu", max_features=70, n_particles=16).go_one_step(frames[1])   # the split route
    assert tally.marks == []


def _captured(steps, stage_nodes, tail):
    """A capture of `steps` steps: each step's stages add the nodes of
    stage_nodes {stage: kinds}, then `tail` (the stack and the state's
    copy-back). Returns (its marks, in a StageTally; its nodes; their kinds)."""
    tally, nodes, kinds = telemetry.StageTally(), [], []
    for _step in range(steps):
        for stage, added in stage_nodes.items():
            tally.mark(stage, nodes[-1:])              # the node added last: none at first
            nodes += [1000 + 7 * len(nodes) + j for j in range(len(added))]
            kinds += added
    nodes += [5 + j for j in range(len(tail))]
    return tally, nodes, kinds + tail


def test_stage_tally_counts_kernels_by_stage_a_step():
    """Kernels (0) by stage a step; copies (memcpy 1, memset 2) and the rest
    in all."""
    rec = telemetry.GraphRecord("fused", True, 2)
    stage_nodes = dict(zip(telemetry.STAGES, ([0] * 5 + [1], [0, 0], [0] * 7 + [2, 1], [0] * 3, [0] * 4 + [1],
                                              [0, 1, 0, 1, 1])))
    tally, nodes, kinds = _captured(2, stage_nodes, tail=[0, 1, 1, 1, 1, 5])
    tally.close(rec, nodes, kinds)
    assert rec.stage_kernels == {"s1_2": 5, "s3": 2, "s4_6": 7, "s7": 3, "s8": 4, "tail": 2.5}
    assert (rec.kernel_nodes, rec.copy_nodes, rec.other_nodes) == (47, 18, 1)
    assert sum(rec.stage_kernels.values()) == rec.kernel_nodes / rec.steps


def test_stage_tally_splits_at_the_latest_of_several_last_nodes_and_refuses_marks_out_of_order():
    rec = telemetry.GraphRecord("fused", True, 1)
    tally = telemetry.StageTally()
    nodes, kinds = [11, 12, 13, 14, 15], [0, 0, 0, 1, 0]
    tally.mark("s1_2", [])
    tally.mark("s3", [12, 11])                         # a stream that waits on two nodes: after the later
    tally.mark("tail", [14])
    tally.close(rec, nodes, kinds)
    assert rec.stage_kernels == {"s1_2": 2, "s3": 1, "tail": 1}
    tally.mark("s8", [12])                             # a mark behind the last one: no stage is known
    tally.close(rec, nodes, kinds)
    assert rec.stage_kernels == {} and rec.kernel_nodes == 4


def _regions(tally, marks, nodes):
    """Region marks at node positions: (name, entering, nodes added before
    the mark); the capture's last node at that point."""
    for name, entering, before in marks:
        tally.region(name, entering, nodes[before - 1:before] if before else [])


def test_region_tally_counts_nested_regions_and_a_region_inside_its_own_name_once():
    """Two steps: ekf.update holds mm_seq, which holds another mm_seq (a
    kernel inside both counts once for mm_seq), and a second ekf.update
    span adds to the first; ekf.predict holds no mm_seq."""
    rec = telemetry.GraphRecord("split", True, 2)
    tally = telemetry.StageTally()
    one = [0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 2, 0, 0]       # kernels 0, copies 1 and 2: 11 kernels a step
    nodes = [100 + i for i in range(2 * len(one))]
    kinds = one + one
    for step in (0, 13):
        tally.mark("s1_2", nodes[step - 1:step] if step else [])
        _regions(tally, [("ekf.predict", True, step), ("ekf.predict", False, step + 2),
                         ("ekf.update", True, step + 3), ("mm_seq", True, step + 4),
                         ("mm_seq", True, step + 5), ("mm_seq", False, step + 7),
                         ("mm_seq", False, step + 8), ("ekf.update", False, step + 9),
                         ("ekf.update", True, step + 10), ("ekf.update", False, step + 12)], nodes)
    tally.close(rec, nodes, kinds)
    # ekf.predict: nodes 0-1; mm_seq: 4-7 (5 a copy); ekf.update: 3-8 and 10-11 (10 a memset)
    assert rec.region_kernels == {"ekf.predict": 2, "mm_seq": 3, "ekf.update": 6}
    assert rec.stage_kernels == {"s1_2": 11}
    assert rec.as_dict()["region_kernels"] == rec.region_kernels


def test_regions_leave_the_stage_counts_as_they_are():
    stage_nodes = dict(zip(telemetry.STAGES, ([0] * 5 + [1], [0, 0], [0] * 7 + [2, 1], [0] * 3, [0] * 4 + [1],
                                              [0, 1, 0, 1, 1])))
    plain, with_regions = telemetry.GraphRecord("split", True, 2), telemetry.GraphRecord("split", True, 2)
    tally, nodes, kinds = _captured(2, stage_nodes, tail=[0, 1])
    tally.close(plain, nodes, kinds)
    tally, nodes, kinds = _captured(2, stage_nodes, tail=[0, 1])
    _regions(tally, [("ekf.update", True, 11), ("mm_seq", True, 12), ("mm_seq", False, 15),
                     ("ekf.update", False, 18)], nodes)
    tally.close(with_regions, nodes, kinds)
    assert with_regions.stage_kernels == plain.stage_kernels
    assert with_regions.region_kernels == {"ekf.update": 2.5, "mm_seq": 1.5}     # nodes 11-17, 12-14
    assert plain.region_kernels == {}


@pytest.mark.parametrize("marks", [
    [("mm_seq", True, 4), ("mm_seq", False, 2)],                       # an exit behind its entry
    [("mm_seq", True, 1), ("ekf.update", True, 3), ("mm_seq", False, 2), ("ekf.update", False, 4)],
    [("mm_seq", False, 2)],                                            # an exit with no entry
    [("mm_seq", True, 1), ("mm_seq", True, 2), ("mm_seq", False, 3)],  # one entry never left
], ids=["backwards", "interleaved-behind", "no-entry", "unclosed"])
def test_region_marks_out_of_order_or_unbalanced_leave_region_kernels_empty(marks):
    rec = telemetry.GraphRecord("split", True, 1)
    tally = telemetry.StageTally()
    nodes, kinds = [11, 12, 13, 14, 15], [0, 0, 0, 0, 0]
    tally.mark("s1_2", [])
    _regions(tally, marks, nodes)
    tally.close(rec, nodes, kinds)
    assert rec.region_kernels == {} and rec.stage_kernels == {"s1_2": 5}


def test_region_is_a_no_op_outside_a_capture(world, monkeypatch):
    frames, cfg = world

    def driver():
        raise AssertionError("a region outside a capture asked the driver")

    assert telemetry._capture is None and telemetry.region("mm_seq") is telemetry._OFF
    tally = telemetry.StageTally()
    split = MonoSLAM(cfg, device="cpu", max_features=70, n_particles=16)
    monkeypatch.setattr(telemetry, "_driver", driver)
    monkeypatch.setattr(telemetry, "_capture", tally)      # a capture open, but no stream capturing
    split.go_one_step(frames[1])
    split.run_sequence(frames[2:4])
    assert tally.regions == [] and tally.marks == []


class _FakeCapture(TorchDispatchMode):
    """A capture on the CPU: every tensor operation that is no view adds a
    kernel node, and the driver's queries read these nodes."""

    def __init__(self):
        super().__init__()
        self.nodes: list = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            self.nodes.append(len(self.nodes) + 1)
        return out

    def capture(self, stream):
        return 7, self.nodes[-1:]

    def node_type(self, node):
        return 0

    def nodes_of(self, graph):
        return list(self.nodes)


@contextlib.contextmanager
def _fake_capture(monkeypatch, regions: bool = True):
    """A capture on the CPU (_FakeCapture) into the record it yields."""
    fake = _FakeCapture()
    driver = types.SimpleNamespace(capture=fake.capture, nodes=fake.nodes_of, node_type=fake.node_type)
    rec = telemetry.GraphRecord("split", True, 1)
    with monkeypatch.context() as m:
        m.setattr(telemetry, "_driver", lambda: driver)
        m.setattr(telemetry, "_capturing_stream", lambda: 0)
        if not regions:
            m.setattr(telemetry, "region", lambda name: telemetry._OFF)
        with fake, telemetry.capture_stages(rec):
            yield rec


def _captured_step(slam, frame, monkeypatch, regions: bool = True) -> telemetry.GraphRecord:
    """One step of slam in a capture on the CPU; its record."""
    state = SlamState(*(t.clone() for t in slam.state))
    with _fake_capture(monkeypatch, regions) as rec:
        slam._step(state, torch.as_tensor(frame), True)
    return rec


def test_the_split_routes_regions_in_a_capture_on_the_cpu(world, monkeypatch):
    """The split route's marks, in a capture whose every tensor operation
    is a kernel: the three regions inside their stages, mm_seq inside
    ekf.predict and ekf.update, and the stage counts as without regions."""
    frames, cfg = world
    slam = MonoSLAM(cfg, device="cpu", max_features=70, n_particles=16)
    assert slam._step.route == "split"
    rec = _captured_step(slam, frames[1], monkeypatch)
    plain = _captured_step(slam, frames[1], monkeypatch, regions=False)
    got, stages = rec.region_kernels, rec.stage_kernels
    assert set(got) == set(telemetry.REGIONS), got
    assert stages == plain.stage_kernels and plain.region_kernels == {}
    assert 0 < got["ekf.predict"] <= stages["s1_2"] and 0 < got["ekf.update"] <= stages["s4_6"]
    assert got["mm_seq"] <= rec.kernel_nodes
    assert sum(stages.values()) == rec.kernel_nodes


def test_mm_seq_counts_once_when_nested(monkeypatch):
    """mm_seq inside ekf.predict, and an mm_seq inside an mm_seq region:
    the kernels of one product of K = 4 are 1 product and 3 sums."""
    from scenelib2_torch.core.quaternion import mm_seq

    a, b = torch.ones(2, 4), torch.ones(4, 3)
    with _fake_capture(monkeypatch) as rec:
        telemetry.stage("s1_2")
        with telemetry.region("ekf.predict"):
            with telemetry.region("mm_seq"):
                mm_seq(a, b)
            a + 1
    assert rec.region_kernels == {"ekf.predict": 5, "mm_seq": 4}


def test_graph_records_list_the_facades_graphs(world, graph_path):
    frames, cfg = world
    slam = graph_path(MonoSLAM(cfg, device="cpu", **OVERRIDES))
    slam.run_sequence(frames[1:11])                    # 8 + 1 + 1
    slam.go_one_step(frames[11])
    got = {(g["route"], g["mapping"], g["steps"]): g["replays"] for g in slam.graphs()}
    assert got == {("fused", True, 8): 1, ("fused", True, 1): 3}
    telemetry.register(slam._graphs[next(iter(slam._graphs))].record)
    assert slam.graphs()[0] in telemetry.graphs()


def test_cli_run_writes_the_runs_counters_and_spans(world, tmp_path):
    import json
    import os

    from scenelib2_torch import cli
    from scenelib2_torch.io.pgm import write_pgm

    frames, cfg = world
    seq = tmp_path / "seq"
    os.makedirs(seq)
    for i, f in enumerate(frames[:8]):
        write_pgm(str(seq / f"frame_{i:04d}.pgm"), f)
    out = tmp_path / "run"
    cli.main(["run", "--config", cfg, "--seq", str(seq), "--out", str(out), "--mapping", "--max-features", "8",
              "--profile", "--cpu"])
    with open(out / "telemetry.json") as f:
        got = json.load(f)
    rec = got["sequence"]
    assert rec["frames"] == rec["n"]["call"] == 7 and rec["profiled"]
    assert 0 < rec["ns"]["launch"] + rec["ns"]["upload"] + rec["ns"]["wait"] <= rec["ns"]["call"]
    assert got["graphs"] == [] and got["stages"] == list(telemetry.STAGES)     # the CPU steps eagerly
    with open(out / "profile" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"slam.go_one_step", "slam.upload", "slam.step", "slam.fetch"} <= names


@pytest.mark.chip
def test_stage_kernels_and_spans_on_the_card(tmp_path):
    """The 8-step graph's kernels by stage sum to its kernel nodes over 8;
    a profile of replays with the device's activities only holds no slam.*
    event, and the records of that pass are marked profiled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from torch.profiler import ProfilerActivity, profile

    from scenelib2_torch.eval.synthetic import generate_dataset

    frames, _rs, _qs, cfg = generate_dataset(str(tmp_path), n_frames=20)
    slam = MonoSLAM(cfg, max_features=16)
    slam.run_sequence(frames[1:20])                    # 2 x 8 + 3 x 1
    graphs = {g["steps"]: g for g in slam.graphs()}
    eight = graphs[8]
    assert set(eight["stage_kernels"]) == set(telemetry.STAGES), eight
    assert sum(eight["stage_kernels"].values()) == pytest.approx(eight["kernel_nodes"] / 8)
    assert eight["kernel_nodes"] > 0 and eight["capture_s"] > 0 and eight["replays"] == 2
    assert sum(graphs[1]["stage_kernels"].values()) == graphs[1]["kernel_nodes"]
    for acts in ([ProfilerActivity.CUDA], [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        slam.reset()
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            slam.run_sequence(frames[1:20])
            slam.go_one_step(frames[1])
            torch.cuda.synchronize()
        assert slam.counters.profiled
        device = [e.name() for e in prof.profiler.kineto_results.events()
                  if e.device_type() == torch.autograd.DeviceType.CUDA]
        assert device and not [n for n in device if n.startswith("slam.")]
        host = {e.name for e in prof.events() if e.name.startswith("slam.")}
        assert bool(host) == (ProfilerActivity.CPU in acts), host


@pytest.mark.chip
def test_region_kernels_of_the_split_route_on_the_card(tmp_path):
    """At 62 slots (D = 385, the split route) the 8-step graph's regions lie
    inside their stages, and its stage counts still sum to its kernel
    nodes over 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from scenelib2_torch.eval.synthetic import generate_dataset

    frames, _rs, _qs, cfg = generate_dataset(str(tmp_path), n_frames=20)
    slam = MonoSLAM(cfg, max_features=62)
    assert slam._step.route == "split"
    slam.run_sequence(frames[1:20])
    eight = {g["steps"]: g for g in slam.graphs()}[8]
    stages, regions = eight["stage_kernels"], eight["region_kernels"]
    assert set(regions) == set(telemetry.REGIONS), regions
    assert sum(stages.values()) == pytest.approx(eight["kernel_nodes"] / 8)
    assert 0 < regions["ekf.predict"] <= stages["s1_2"] and 0 < regions["ekf.update"] <= stages["s4_6"]
    assert 0 < regions["mm_seq"] <= eight["kernel_nodes"] / 8
