"""idle_share.seq: 1 - the device's busy time over the wall time of the
traced pass of a run_sequence cell, both of that one pass: busy is the
union of every device activity's interval in its trace (the device's
activities only), wall the host's clock from the pass's start to its end,
the device synchronised at both. The profiler slows the pass (the slowdown
is printed beside the result): its idle share holds the profiler's launch
cost too."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["entry"] != "run_sequence" or tr.window_s <= 0:
        return None
    return 1.0 - tr.busy_s / tr.window_s
