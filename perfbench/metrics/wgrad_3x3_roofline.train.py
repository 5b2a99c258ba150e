"""The weight-gradient kernel (csrc/wgrad_3x3.cu: its tile, tensor-core
and split-reduction kernels) against its roofline: the least time of the
37 stride-1 3x3 weight gradients of each traced step (``counts``), over
the kernel's device time, in percent."""

from perfbench.harness import counts, readers

KERNELS = ("wgrad_tc", "wgrad_tiles", "wgrad_reduce")


def read(ctx):
    if ctx.run.trace is None:
        return None
    spent = sum(e - s for _, s, e in readers.window_events(
        ctx, "kernel", KERNELS)) / 1e9
    if not spent:
        return None
    cfg = ctx.cell.config
    least = sum(counts.wgrad_least_s(c["images"], cfg["img_size"],
                                     cfg["num_classes"],
                                     tuple(cfg["csp_repeats"]))
                for c in ctx.run.calls)
    return 100.0 * least / spent
