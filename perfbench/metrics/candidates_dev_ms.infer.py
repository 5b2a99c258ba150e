"""Device time of the program's ``candidates`` span in ``predict_batch``:
the candidate top-k and decode (``ops/detect.select_candidates``),
from its start event to its end event on the stream (idle inside
included), mean over the traced window's calls, in ms; None on the CPU."""

from perfbench.harness import program_trace


def read(ctx):
    return program_trace.per_call_ms(ctx, "predict_batch", "candidates",
                                     device=True)
