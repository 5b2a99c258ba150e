"""Device time of the host-to-device copies per call (predict_batch's
upload of the uint8 batch), in ms."""

from perfbench.harness import readers


def read(ctx):
    if ctx.run.trace is None:
        return None
    ev = readers.window_events(ctx, "memcpy_htod")
    return sum(e - s for _, s, e in ev) / 1e6 / len(ctx.run.calls)
