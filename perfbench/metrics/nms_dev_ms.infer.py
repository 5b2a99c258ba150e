"""Device time of the program's ``nms`` span in ``predict_batch``: the
NMS tail (``nms_cuda.nms_from_candidates``: rank sorts, ``suppress_rank``,
merge), from its start event to its end event on the stream (idle inside
included), mean over the traced window's calls, in ms; None on the CPU."""

from perfbench.harness import program_trace


def read(ctx):
    return program_trace.per_call_ms(ctx, "predict_batch", "nms",
                                     device=True)
