"""step_kernels.s4_6: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in stages 4-6: the joint update, the
normalisation, the bookkeeping and the deletion, counted when the graph was
captured (scenelib2_torch/runtime/telemetry.py). run_sequence cells only."""

from perfbench import program


def read(ctx):
    return program.stage_kernels(ctx, "s4_6")
