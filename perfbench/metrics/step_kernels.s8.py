"""step_kernels.s8: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in stage 8: the partial features'
particles and the state surgery, counted when the graph was captured
(scenelib2_torch/runtime/telemetry.py). run_sequence cells only."""

from perfbench import program


def read(ctx):
    return program.stage_kernels(ctx, "s8")
