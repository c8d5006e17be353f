"""The per-layer readers on a trace of known shape, and the reduction of a
trace to busy time, idle gaps and the breakdown."""

import types

import pytest
import torch

from perfbench import harness, trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Ev:
    def __init__(self, name, start, dur, dev):
        self._n, self._s, self._d, self._dev = name, start, dur, dev

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev


def fake_trace():
    """A 1,000 ns window: two calls of 400 ns, each with two kernels (100
    and 100 ns, overlapping by 50) and a copy; the device idle 650 ns. The
    profiler mirrors the harness's spans on the device's timeline: they are
    no device work."""
    evs = [Ev("bench.traced_pass", 0, 1000, CPU), Ev("bench.traced_pass", 0, 1000, CUDA)]
    for k, t in enumerate((0, 500)):
        evs += [Ev("bench.call", t, 400, CPU), Ev("bench.call", t, 400, CUDA), Ev("aten::copy_", t + 300, 100, CPU),
                Ev("k_update", t + 100, 100, CUDA), Ev("k_search", t + 150, 100, CUDA),
                Ev("Memcpy HtoD", t + 250, 25, CUDA)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    return trace.Trace(prof, "bench.traced_pass", 1e-6)


def test_busy_is_the_union_of_device_intervals():
    tr = fake_trace()
    assert tr.window_s == pytest.approx(1e-6)
    assert tr.busy_s == pytest.approx(2 * 175e-9)
    assert tr.kernels == 4


def test_without_host_events_the_host_clock_gives_the_window():
    evs = [Ev("k_update", 100, 100, CUDA), Ev("k_search", 500, 100, CUDA)]
    prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: evs)))
    tr = trace.Trace(prof, "bench.traced_pass", 2e-6)
    assert tr.window_s == 2e-6 and tr.busy_s == pytest.approx(200e-9)


def test_breakdown_puts_idle_time_to_the_host():
    b = fake_trace().breakdown()
    assert b["device_ops"][0] == ["k_update", pytest.approx(200e-9)]
    idle = dict(b["idle_gaps"])
    assert sum(idle.values()) == pytest.approx(1e-6 - 350e-9)
    # gaps [0, 100), [275, 600), [775, 1000), each put to what was open at its middle
    assert idle["bench.call"] == pytest.approx(100e-9)
    assert idle["(no host event)"] == pytest.approx(325e-9)
    assert idle["bench.call > aten::copy_"] == pytest.approx(225e-9)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


def ctx(entry, **kw):
    base = dict(entry=entry, trace=fake_trace(), traced_steps=2, frames=100, window_s=2.0, setup_s=5.0,
                capture_s=0.3, call_walls=[1e-3, 2e-3, 3e-3, 4e-3], least_s=1e-9, traced_units=2)
    base.update(kw)
    return base


def test_replay_readers():
    c = ctx("run_sequence")
    assert harness.reader("frames_per_s")(c) == 50.0
    assert harness.reader("lane_frames_per_s")(c) is None
    # busy 350 ns of the traced pass's 1,000 ns
    assert harness.reader("idle_share.seq")(c) == pytest.approx(0.65)
    assert harness.reader("idle_share.live")(c) is None
    assert harness.reader("idle_share.batch")(c) is None
    assert harness.reader("launches_per_step")(c) == 2.0
    assert harness.reader("launches_per_step.batch")(c) is None
    assert harness.reader("step_roofline")(c) == pytest.approx(100 * 1e-9 / 350e-9)
    assert harness.reader("call_ms_p95")(dict(c, call_walls=[])) is None


def test_batch_readers():
    c = ctx("run_batch")
    assert harness.reader("frames_per_s")(c) is None
    assert harness.reader("lane_frames_per_s")(c) == 50.0
    assert harness.reader("idle_share.batch")(c) == pytest.approx(0.65)
    assert harness.reader("launches_per_step.batch")(c) == 2.0
    assert harness.reader("step_roofline.batch")(c) == pytest.approx(100 * 1e-9 / 350e-9)
    assert harness.reader("step_roofline")(c) is None


def test_live_readers():
    c = ctx("go_one_step")
    assert harness.reader("frames_per_s")(c) is None
    assert harness.reader("call_ms_p95")(c) == pytest.approx(3.85)
    # the traced pass's 650 ns of idle over its 2 calls
    assert harness.reader("call_host_ms")(c) == pytest.approx(325e-6)
    assert harness.reader("idle_share.live")(c) == pytest.approx(0.65)


def test_idle_share_stays_between_0_and_1():
    """Busy and wall come from the one traced pass: the device's intervals
    lie inside its wall."""
    for c in (ctx("run_sequence"), ctx("run_batch"), ctx("go_one_step")):
        for name in ("idle_share.seq", "idle_share.batch", "idle_share.live"):
            v = harness.reader(name)(c)
            assert v is None or 0.0 <= v <= 1.0


def test_readers_find_nothing_without_a_trace():
    c = ctx("run_sequence", trace=None)
    for name in ("idle_share.seq", "idle_share.batch", "launches_per_step", "launches_per_step.batch",
                 "step_roofline", "step_roofline.batch", "call_host_ms"):
        assert harness.reader(name)(c) is None
    assert harness.reader("capture_s")(dict(c, capture_s=0.0)) is None
