"""Model FLOPs of the images served in the traced window over the window
at the H100's bf16 peak (``readers.mfu``, one forward an image)."""

from perfbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, passes=1)
