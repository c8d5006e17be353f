"""The region_kernels.* readers (perfbench/regions.py): the kernel nodes a
step in one region of the graph with the most steps, from a registry of
graph records of known values; None where the program counts no regions."""

import pytest

from perfbench import harness, program
from scenelib2_torch.runtime import telemetry

READERS = {"region_kernels.mm_seq": "mm_seq", "region_kernels.ekf_update": "ekf.update",
           "region_kernels.ekf_predict": "ekf.predict"}


def ctx(entry):
    return dict(entry=entry, trace=None, frames=0, window_s=1.0, call_walls=[])


@pytest.fixture
def registry(monkeypatch):
    graphs = []
    monkeypatch.setattr(telemetry, "graphs", lambda: graphs)
    return graphs


def record(steps, region_kernels=None) -> dict:
    rec = telemetry.GraphRecord("split", True, steps)
    rec.stage_kernels = dict.fromkeys(telemetry.STAGES, 3.0)
    rec.region_kernels = dict(region_kernels or {})
    return rec.as_dict()


def test_the_graph_with_the_most_steps(registry):
    registry.extend([record(1, {"mm_seq": 1.0, "ekf.update": 1.0, "ekf.predict": 1.0}),
                     record(8, {"mm_seq": 1843.5, "ekf.update": 1790.0, "ekf.predict": 61.25}),
                     record(3, {"mm_seq": 2.0})])
    got = {m: harness.reader(m)(ctx("run_sequence")) for m in READERS}
    assert got == {"region_kernels.mm_seq": 1843.5, "region_kernels.ekf_update": 1790.0,
                   "region_kernels.ekf_predict": 61.25}


@pytest.mark.parametrize("name", READERS)
def test_none_on_the_parents_records(name, registry):
    """An older commit's records have stages and no region_kernels."""
    parent = record(8)
    del parent["region_kernels"]
    registry.append(parent)
    assert harness.reader(name)(ctx("run_sequence")) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_the_region_was_not_entered(name, registry):
    registry.append(record(8, {k: 5.0 for k in READERS.values() if k != READERS[name]}))
    assert harness.reader(name)(ctx("run_sequence")) is None


@pytest.mark.parametrize("name", READERS)
def test_none_on_another_entry_point_and_before_any_graph(name, registry):
    read = harness.reader(name)
    assert read(ctx("run_sequence")) is None
    registry.append(record(8, dict.fromkeys(READERS.values(), 7.0)))
    assert read(ctx("run_sequence")) == 7.0
    assert read(ctx("go_one_step")) is None
    assert read(ctx("run_batch")) is None


@pytest.mark.parametrize("name", READERS)
def test_none_for_a_program_that_counts_nothing(name, monkeypatch):
    monkeypatch.setattr(program, "_telemetry", lambda: None)
    assert harness.reader(name)(ctx("run_sequence")) is None
