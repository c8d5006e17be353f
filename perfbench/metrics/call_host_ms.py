"""call_host_ms: the traced pass's wall time less its device-busy time,
over its go_one_step calls, in ms, both of that one pass (as idle_share.live
takes them): the host's part of a call (the frame's upload, the state
copied into the one-step graph and out of it, the graph's launch, the
pose's fetch, the pass's reset shared out), with the profiler's launch cost
in it."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["entry"] != "go_one_step" or not ctx["traced_units"]:
        return None
    return (tr.window_s - tr.busy_s) / ctx["traced_units"] * 1e3
