"""Kernel nodes a step inside a named region of scenelib2_torch's step
(runtime/telemetry.py ``region``), for the region_kernels.* readers: the
graph with the most steps captured, in a run_sequence cell.

None where there is nothing to read: in a cell of another entry point,
before any graph, and in a program whose graph records count no regions
(an older commit)."""

from __future__ import annotations

from perfbench import program


def region_kernels(ctx, region: str) -> float | None:
    """Kernel nodes a step in region `region` of the graph with the most
    steps."""
    tel = program._telemetry() if ctx["entry"] == "run_sequence" else None
    graphs = tel.graphs() if tel is not None else []
    if not graphs:
        return None
    return max(graphs, key=lambda g: g["steps"]).get("region_kernels", {}).get(region)
