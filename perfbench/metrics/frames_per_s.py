"""frames_per_s: every frame the window completed over the window's wall
time; whole passes, from the first pass's start to the last one's end, each
pass's reset, upload, replay and fetch inside. run_sequence cells only."""


def read(ctx):
    if ctx["entry"] != "run_sequence":
        return None
    return ctx["frames"] / ctx["window_s"]
