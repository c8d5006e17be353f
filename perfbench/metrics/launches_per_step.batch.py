"""launches_per_step.batch: device kernels in the traced pass (copies and
fills left out) over its batched steps, each step every lane's frame.
run_batch cells only."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["entry"] != "run_batch" or not tr.kernels:
        return None
    return tr.kernels / ctx["traced_steps"]
