"""Share of the traced window in which the prefetch thread was inside the
program's ``ingest.batch`` (``DataGenerator.get_batch``: read, decode,
resize, encode) or ``ingest.place`` (the pin and the asynchronous copy)
spans, their union over the window, in percent."""

from perfbench.harness import program_trace


def read(ctx):
    busy = program_trace.host_union(ctx, ("ingest.batch", "ingest.place"))
    if not busy:
        return None
    return 100.0 * sum(e - s for s, e in busy) / (
        ctx.run.window[1] - ctx.run.window[0])
