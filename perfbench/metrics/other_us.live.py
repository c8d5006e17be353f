"""other_us.live: a go_one_step call's mean host wall less its upload,
copies, launch and wait (upload_us.live, copies_us.live, launch_us.live,
wait_us.live): the facade's own Python, the graph's lookup, the outputs'
unpacking and the trajectory, over the calls of the run's last untraced
pass. go_one_step cells only."""

from perfbench import program


def read(ctx):
    return program.live_us(ctx, "other")
