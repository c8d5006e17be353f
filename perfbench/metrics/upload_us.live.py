"""upload_us.live: host microseconds a go_one_step call spends uploading
its frame (the slam.upload part: the u8 array from host memory to the
device), over the calls of the run's last untraced pass. go_one_step
cells only."""

from perfbench import program


def read(ctx):
    return program.live_us(ctx, "upload")
