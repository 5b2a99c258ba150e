"""Model FLOPs of the training steps in the traced window over the window
at the H100's bf16 peak (``readers.mfu``, three forwards' worth an image:
forward, input gradient, weight gradient)."""

from perfbench.harness import readers


def read(ctx):
    return readers.mfu(ctx, passes=3)
