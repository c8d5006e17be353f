"""copies_us.live: host microseconds a go_one_step call spends issuing the
copies into and out of the one-step graph (slam.copy_in: the state and the
frame into its static inputs; slam.copy_out: the packed row and the state
out of its tensors), over the calls of the run's last untraced pass.
go_one_step cells only."""

from perfbench import program


def read(ctx):
    return program.live_us(ctx, "copies")
