"""wait_us.seq: host microseconds a frame spends blocked in the outputs'
fetch (slam.fetch: the host waiting on the device for the packed rows) in
the run_sequence calls of the run's last untraced pass. run_sequence cells
only."""

from perfbench import program


def read(ctx):
    return program.sequence_us(ctx, "wait")
