"""wait_us.live: host microseconds a go_one_step call spends blocked in the
pose's fetch (slam.fetch: the host waiting on the device), over the calls
of the run's last untraced pass. go_one_step cells only."""

from perfbench import program


def read(ctx):
    return program.live_us(ctx, "wait")
