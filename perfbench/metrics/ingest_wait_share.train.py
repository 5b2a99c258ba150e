"""Share of the traced window in which the training loop blocked in
next() of the prefetch iterator (DataGenerator + prefetch), from the
benchmark's own span around that call, in percent."""

from perfbench.harness import readers


def read(ctx):
    if ctx.run.spans is None or ctx.run.trace is None:
        return None
    return 100.0 * readers.span_s(ctx, "next_batch") / ctx.window_s
