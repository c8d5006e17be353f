"""lane_frames_per_s: every lane-frame the window completed (lanes x
frames of each pass) over the window's wall time; whole passes, from the
first pass's start to the last one's end, each pass's upload, replay and
fetch inside. run_batch cells only."""


def read(ctx):
    if ctx["entry"] != "run_batch":
        return None
    return ctx["frames"] / ctx["window_s"]
