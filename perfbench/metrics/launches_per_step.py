"""launches_per_step: device kernels in the traced pass (copies and fills
left out) over its frames. run_sequence cells only."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["entry"] != "run_sequence" or not tr.kernels:
        return None
    return tr.kernels / ctx["traced_steps"]
