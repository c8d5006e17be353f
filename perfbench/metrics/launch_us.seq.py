"""launch_us.seq: host microseconds a frame spends in graph launches
(slam.launch: cudaGraphLaunch of the 8-step and the one-step graphs) in the
run_sequence calls of the run's last untraced pass. run_sequence cells
only."""

from perfbench import program


def read(ctx):
    return program.sequence_us(ctx, "launch")
