"""Device time of the program's ``forward`` spans in ``train_step``:
the normalise, the on-device encode, ``network.apply`` and the loss,
from start event to end event on the stream (idle inside included, and
the producer's copies that land there), summed a step, mean over the
traced window's steps, in ms; None on the CPU."""

from perfbench.harness import program_trace


def read(ctx):
    return program_trace.per_call_ms(ctx, "train_step", "forward",
                                     device=True)
