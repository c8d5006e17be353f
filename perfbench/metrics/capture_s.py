"""capture_s: host seconds of the CUDA-graph captures and their
instantiation in the set-up's warm pass (StepGraph.capture_s of every graph
the system keeps; their warm-up steps apart)."""


def read(ctx):
    return ctx["capture_s"] if ctx["capture_s"] > 0 else None
