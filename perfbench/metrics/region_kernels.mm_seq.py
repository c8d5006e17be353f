"""region_kernels.mm_seq: kernel nodes a step of the graph with the most steps
(run_sequence's 8-step graph) holds in the step region mm_seq: every call of
core/quaternion.py mm_seq (products summed left to right), in whatever stage
or region it lies; counted when the graph was captured
(scenelib2_torch/runtime/telemetry.py). run_sequence cells only; None for a
program that counts no regions."""

from perfbench import regions


def read(ctx):
    return regions.region_kernels(ctx, "mm_seq")
