"""step_roofline: the least time of the traced pass's work on one H100
(perfbench/work.py: per stage from the frames' shapes and decisions; the
larger of bytes / 3.35 TB/s and operations / 67 TFLOP/s over the pass) over
the device's busy time in that pass, in %. run_sequence cells only."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx["entry"] != "run_sequence" or tr.busy_s <= 0 or not ctx.get("least_s"):
        return None
    return 100.0 * ctx["least_s"] / tr.busy_s
