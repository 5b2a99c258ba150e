"""infer_img_per_s: images whose detections reached the host in the
window, over the window (the first call's start to the last call's end),
on the host clock."""

from perfbench.harness import readers


def read(ctx):
    return readers.images(ctx) / ctx.window_s
