"""The readers of what scenelib2_torch counts about itself
(perfbench/program.py and the metrics that use it), on a sequence record
and a registry of graphs of known values."""

import collections

import pytest

from perfbench import harness, program
from scenelib2_torch.runtime import telemetry

LIVE = ("upload_us.live", "copies_us.live", "launch_us.live", "wait_us.live", "other_us.live")
SEQ = ("launch_us.seq", "wait_us.seq")
STAGE = tuple(f"step_kernels.{s}" for s in telemetry.STAGES)


def ctx(entry):
    return dict(entry=entry, trace=None, frames=0, window_s=1.0, call_walls=[])


def record(profiled=False, **ns):
    rec = telemetry.SequenceRecord()
    for part, (spent, count) in ns.items():
        rec.ns[part], rec.n[part] = spent, count
    rec.profiled = profiled
    return rec


@pytest.fixture
def sequences(monkeypatch):
    """An empty store of sequence records in place of the process's."""
    store = collections.deque(maxlen=telemetry.KEEP_SEQUENCES)
    monkeypatch.setattr(telemetry, "_sequences", store)
    return store


@pytest.fixture
def registry(monkeypatch):
    graphs = []
    monkeypatch.setattr(telemetry, "graphs", lambda: [g.as_dict() for g in graphs])
    return graphs


def test_live_parts_of_the_latest_untraced_pass(sequences):
    # 4 calls of 1,000 us; upload 40 us, copies 200 us, launch 320 us, wait 280 us a call
    rec = record(call=(4_000_000, 4), upload=(160_000, 4), copies=(800_000, 8), launch=(1_280_000, 4),
                 wait=(1_120_000, 4))
    traced = record(profiled=True, call=(9_000_000, 4), upload=(1, 4), copies=(1, 8), launch=(1, 4), wait=(1, 4))
    sequences.extend([record(call=(1, 1)), rec, traced])
    got = {m: harness.reader(m)(ctx("go_one_step")) for m in LIVE}
    assert got == pytest.approx({"upload_us.live": 40.0, "copies_us.live": 200.0, "launch_us.live": 320.0,
                                 "wait_us.live": 280.0, "other_us.live": 160.0})
    assert sum(got.values()) == pytest.approx(1000.0)


def test_sequence_parts_a_frame(sequences):
    rec = record(sequence=(2_390_000, 10), launch=(1_195_000, 300), wait=(478_000, 10))
    rec.frames = 2390
    sequences.append(rec)
    assert harness.reader("launch_us.seq")(ctx("run_sequence")) == pytest.approx(0.5)
    assert harness.reader("wait_us.seq")(ctx("run_sequence")) == pytest.approx(0.2)


def test_stage_kernels_of_the_graph_with_the_most_steps(registry):
    one, eight = telemetry.GraphRecord("fused", True, 1), telemetry.GraphRecord("fused", True, 8)
    one.stage_kernels = dict.fromkeys(telemetry.STAGES, 1.0)
    eight.stage_kernels = {"s1_2": 120.0, "s3": 40.5, "s4_6": 150.0, "s7": 90.0, "s8": 160.0, "tail": 15.875}
    registry.extend([one, eight])
    got = {m.split(".", 1)[1]: harness.reader(m)(ctx("run_sequence")) for m in STAGE}
    assert got == eight.stage_kernels


@pytest.mark.parametrize("name", LIVE + SEQ + STAGE)
def test_none_on_the_other_entry_point_and_with_no_record(name, sequences, registry):
    mine = "go_one_step" if name.endswith(".live") else "run_sequence"
    other = "run_sequence" if mine == "go_one_step" else "go_one_step"
    read = harness.reader(name)
    assert read(ctx(mine)) is None                       # no record, no graph yet
    rec = record(call=(1000, 1), sequence=(1000, 1), upload=(1, 1), launch=(1, 1), wait=(1, 1))
    rec.frames = 1
    sequences.append(rec)
    g = telemetry.GraphRecord("fused", True, 8)
    g.stage_kernels = dict.fromkeys(telemetry.STAGES, 2.0)
    registry.append(g)
    assert read(ctx(mine)) is not None
    assert read(ctx(other)) is None
    assert read(ctx("run_batch")) is None


@pytest.mark.parametrize("name", LIVE + SEQ)
def test_none_where_every_pass_was_traced(name, sequences):
    rec = record(profiled=True, call=(1000, 1), sequence=(1000, 1), launch=(1, 1), wait=(1, 1))
    rec.frames = 1
    sequences.append(rec)
    assert harness.reader(name)(ctx("go_one_step" if name.endswith(".live") else "run_sequence")) is None


@pytest.mark.parametrize("name", LIVE + SEQ + STAGE)
def test_none_for_a_program_that_counts_nothing(name, monkeypatch):
    """An older commit of the program has no telemetry module."""
    monkeypatch.setattr(program, "_telemetry", lambda: None)
    for entry in ("go_one_step", "run_sequence"):
        assert harness.reader(name)(ctx(entry)) is None
