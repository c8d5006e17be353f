"""region_kernels.ekf_update: kernel nodes a step of the graph with the most
steps (run_sequence's 8-step graph) holds in the step region ekf.update: the
split route's joint update (S^-1 from K14), its normalisation and its
symmetrisation (runtime/step.py make_split_stages); counted when the graph
was captured (scenelib2_torch/runtime/telemetry.py). run_sequence cells
only; None for a program that counts no regions."""

from perfbench import regions


def read(ctx):
    return regions.region_kernels(ctx, "ekf.update")
