"""Share of the traced window in which the device was idle while the
training thread was inside the program's ``forward``, ``backward`` or
``optimizer`` spans of ``train_step``: the part of ``idle_share.train``
that is the program's own dispatch (not the harness, ``next()`` or the
drain), in percent."""

from perfbench.harness import program_trace


def read(ctx):
    stages = program_trace.host_union(
        ctx, ("forward", "backward", "optimizer"), root="train_step")
    if not stages:
        return None
    idle = program_trace.device_idle(ctx)
    return 100.0 * program_trace.overlap_ns(idle, stages) / (
        ctx.run.window[1] - ctx.run.window[0])
