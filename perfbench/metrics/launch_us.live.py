"""launch_us.live: host microseconds a go_one_step call spends in the
one-step graph's launch (slam.launch: cudaGraphLaunch on the host), over
the calls of the run's last untraced pass. go_one_step cells only."""

from perfbench import program


def read(ctx):
    return program.live_us(ctx, "launch")
