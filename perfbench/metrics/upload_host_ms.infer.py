"""Host time a call spends in the program's ``upload`` span (the
host-to-device copy of the uint8 batch in ``Yolov4.predict_batch``), mean
over the traced window's calls, in ms."""

from perfbench.harness import program_trace


def read(ctx):
    return program_trace.per_call_ms(ctx, "predict_batch", "upload",
                                     device=False)
