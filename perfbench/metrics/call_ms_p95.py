"""call_ms_p95: the 95th percentile of the host wall time of every
go_one_step call in the window (the call to its return, the frame's upload
and the pose's fetch inside), in ms. Per-call cells only."""

import numpy as np


def read(ctx):
    walls = ctx["call_walls"]
    if not walls:
        return None
    return float(np.percentile(np.asarray(walls) * 1e3, 95))
