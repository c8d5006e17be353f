"""step_kernels.s1_2: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in stages 1-2: the EKF predict, the
measurement prediction and the selection, counted when the graph was
captured (scenelib2_torch/runtime/telemetry.py). run_sequence cells only."""

from perfbench import program


def read(ctx):
    return program.stage_kernels(ctx, "s1_2")
