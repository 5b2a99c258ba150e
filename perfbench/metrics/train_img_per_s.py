"""train_img_per_s: images of every optimizer step completed in the
window, over the window (the first step's start to the device's end of the
last step), on the host clock."""

from perfbench.harness import readers


def read(ctx):
    return readers.images(ctx) / ctx.window_s
