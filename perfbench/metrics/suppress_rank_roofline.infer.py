"""The suppression kernel (csrc/suppress_rank.cu) against its roofline:
the least time of the NMS problems of the traced calls (each pool batch's
counted on the reference's own candidates: bytes at the HBM rate or IoU
tests at the float32 rate), over the kernel's device time, in percent."""

from perfbench.harness import counts, readers

KERNEL = ("suppress_rank_kernel",)


def read(ctx):
    if ctx.run.trace is None:
        return None
    work = ctx.run.extra.get("nms_work") or {}
    spent = sum(e - s for _, s, e in readers.window_events(
        ctx, "kernel", KERNEL)) / 1e9
    if not spent or not work:
        return None
    least = sum(counts.nms_least_s(work[c["batch"]]) for c in ctx.run.calls)
    return 100.0 * least / spent
