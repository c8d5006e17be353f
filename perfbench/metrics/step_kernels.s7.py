"""step_kernels.s7: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in stage 7: the speed gate and the auto-
initialisation, counted when the graph was captured
(scenelib2_torch/runtime/telemetry.py). run_sequence cells only."""

from perfbench import program


def read(ctx):
    return program.stage_kernels(ctx, "s7")
