"""setup_s: the process's seconds from its start to the window's first
frame: imports, CUDA's start-up, the inputs rendered, the system built, the
warm pass (graph captures, the kernels loaded, and built where the checkout
has not built them yet)."""


def read(ctx):
    return ctx["setup_s"]
