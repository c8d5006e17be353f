"""What scenelib2_torch counts about itself, for the per-layer readers
(metrics/*.py): runtime/telemetry.py's sequence records and its registry of
captured graphs, kept in the process that ran the cell.

Every function returns None where there is nothing to read: in a cell of
the other entry point, before any record, and in a program without that
module (an older commit), which counts nothing."""

from __future__ import annotations

LIVE_PARTS = ("upload", "copies", "launch", "wait")    # a go_one_step call's parts; the rest is "other"


def _telemetry():
    try:
        from scenelib2_torch.runtime import telemetry
    except ImportError:
        return None
    return telemetry


def sequence(ctx, entry: str) -> dict | None:
    """The latest sequence record that no profiler recorded during (a run's
    last untraced pass: the traced passes are the profiler's), as a dict,
    in a cell whose entry point is `entry`."""
    tel = _telemetry() if ctx["entry"] == entry else None
    rec = tel.latest() if tel is not None else None
    return rec.as_dict() if rec is not None else None


def live_us(ctx, part: str) -> float | None:
    """Host microseconds a go_one_step call of that pass spends in `part`
    (LIVE_PARTS, or "other": the call's wall less the LIVE_PARTS)."""
    rec = sequence(ctx, "go_one_step")
    if rec is None or not rec["n"]["call"]:
        return None
    ns = rec["ns"]
    spent = ns["call"] - sum(ns[p] for p in LIVE_PARTS) if part == "other" else ns[part]
    return spent / rec["n"]["call"] / 1e3


def sequence_us(ctx, part: str) -> float | None:
    """Host microseconds a frame of that pass's run_sequence calls spends in `part`."""
    rec = sequence(ctx, "run_sequence")
    if rec is None or not rec["n"]["sequence"] or not rec["frames"]:
        return None
    return rec["ns"][part] / rec["frames"] / 1e3


def stage_kernels(ctx, stage: str) -> float | None:
    """Kernel nodes a step of the graph with the most steps captured in
    step stage `stage`, in a run_sequence cell."""
    tel = _telemetry() if ctx["entry"] == "run_sequence" else None
    graphs = tel.graphs() if tel is not None else []
    if not graphs:
        return None
    return max(graphs, key=lambda g: g["steps"])["stage_kernels"].get(stage)
