"""step_kernels.tail: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in the outputs' assembly and packing,
and the graph's copy of its final state into its inputs, counted when the
graph was captured (scenelib2_torch/runtime/telemetry.py). run_sequence
cells only."""

from perfbench import program


def read(ctx):
    return program.stage_kernels(ctx, "tail")
