"""Every cell (tests/cells.py) at a size a CPU holds: the whole run but
the look for a card (the port's plain CPU path, a short window, the
reference, the comparison). A sound run is correct; a run with the timed
path broken underneath is not, for each fault the cell can have."""

import time

import pytest
import torch

from perfbench import harness, systems
from perfbench.tests.cells import ALL as BENCH, CELLS

SEED = 2 ** 31 + 77             # a seed beyond 32 signed bits


def tiny(name: str) -> harness.Cell:
    """The cell with its stream cut to a CPU's size: 10 frames; or 4 lanes
    (2 textures x 2 offsets) of 12 frames, one sampled from each half."""
    cell = harness.Cell(name, BENCH)
    t = dict(cell.traffic, frames=10)
    if t["entry"] == "run_batch":
        t.update(frames=12, textures=2, offsets=2, sample={"block": 2, "per_block": 1})
    cell.traffic = t
    return cell


def run(name: str):
    torch.set_num_threads(2)
    return harness.run(tiny(name), SEED, 0.2, False, "cpu", time.perf_counter(), ref_workers=1, settle_s=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res, lines = run(name)
    assert res["correct"], lines
    assert res["attempted"] > 0 and res["failed"] == 0
    cell = tiny(name)
    want = {m["name"] for m in cell.end_to_end}
    # on the CPU nothing is captured; every end-to-end metric of the cell is there
    assert set(res["metrics"]) == want
    assert list(res)[-1] == "compared"
    assert set(res["compared"]) == set(cell.limits)


def faults(name):
    entry = harness.Cell(name, BENCH).traffic["entry"]
    out = ["frozen_state", "altered_answer"]
    if entry == "run_batch":
        out.append("half_batch")
    return out


def broken(step, fault: str, lanes: int = 0):
    """step with a fault underneath."""

    def faulty(state, frames, enable_mapping):
        if fault == "half_batch":       # half of the lanes left out, the other half given twice
            half = lanes // 2
            sub = type(state)(*(t[:half] for t in state))
            new, out = step(sub, frames[:half], enable_mapping)
            new = type(state)(*(torch.cat([t, t]) for t in new))
            out = type(out)(*(torch.cat([t, t]) for t in out))
            return new, out
        new, out = step(state, frames, enable_mapping)
        if fault == "frozen_state":
            return state, out
        # altered_answer: the fifth frame's pose 5 cm off where the step makes it, in the state it hands on
        bump = 0.05 * (state.frame_no == 4).to(out.r.dtype)[..., None]
        x = torch.cat([new.x[..., :3] + bump, new.x[..., 3:]], dim=-1)
        return new._replace(x=x), out._replace(r=out.r + bump)

    faulty.__dict__.update(step.__dict__)
    return faulty


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in faults(n)])
def test_fault_is_not_correct(name, fault, monkeypatch):
    """The system is built as a run builds it; then the step under its
    entry point is broken."""
    entry = harness.Cell(name, BENCH).traffic["entry"]
    build = systems.SYSTEMS[entry]

    def build_broken(*args):
        system = build(*args)
        if isinstance(system, systems.Batch):
            system.step = broken(system.step, fault, system.n_lanes)
        else:
            system.slam._step = broken(system.slam._step, fault)
        return system

    monkeypatch.setitem(systems.SYSTEMS, entry, build_broken)
    res, lines = run(name)
    assert not res["correct"], lines


def test_calls_leave_no_outputs_behind(tmp_path):
    """A pass of go_one_step calls keeps its pose and decisions in two
    buffers of its own and no call's outputs, so a window's last pass
    allocates and collects no more than its first; the records read what
    the calls returned."""
    cell = tiny("std-live")
    torch.set_num_threads(2)
    system = systems.SYSTEMS["go_one_step"](cell.config, cell.traffic, SEED, "cpu", str(tmp_path))
    system.run_pass(keep=False)
    assert not system._kept
    system.run_pass()
    system.run_pass(spans=True)
    assert [tuple(t.shape) for pair in system._kept for t in pair] == [(10, 7)] * 4
    last = system.slam.last_output
    system.finish()
    pose, dec = system.records()
    assert pose.shape == (2, 10, 7) and dec.shape == (2, 10, 7)
    assert (pose[0] == pose[1]).all() and (dec[0] == dec[1]).all()
    want_pose, want_dec = systems.compact(type(last)(*(t[None] for t in last)))
    assert (pose[1, -1] == want_pose[0]).all() and (dec[1, -1] == want_dec[0]).all()
    assert system.traced_outs.r.shape[0] == 10 and not system._kept
