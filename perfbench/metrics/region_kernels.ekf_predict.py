"""region_kernels.ekf_predict: kernel nodes a step of the graph with the most
steps (run_sequence's 8-step graph) holds in the step region ekf.predict:
core/ekf.py predict (the camera's motion model and P's camera rows and
columns); counted when the graph was captured
(scenelib2_torch/runtime/telemetry.py). run_sequence cells only; None for a
program that counts no regions."""

from perfbench import regions


def read(ctx):
    return regions.region_kernels(ctx, "ekf.predict")
