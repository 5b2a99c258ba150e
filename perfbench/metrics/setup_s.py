"""setup_s: process start to the first timed call (torch import, CUDA
context, weights, kernel builds or their cache, warm-up of the cell's own
shapes), on the host clock."""


def read(ctx):
    return ctx.setup_s
