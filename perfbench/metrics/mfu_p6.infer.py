"""YOLOv4-P6's model FLOPs of the images served in the traced window
(2 x the multiply-adds of its 205 convolutions at the cell's size, from
the reference's conv list, ``counts_p6``), over the window at the H100's
bf16 peak, in percent."""

from perfbench.harness import counts_p6, peaks, readers


def read(ctx):
    if ctx.run.trace is None:
        return None
    cfg = ctx.cell.config
    flops = readers.images(ctx) * counts_p6.p6_flops(
        cfg["img_size"], cfg["num_classes"], tuple(cfg["csp_repeats"]))
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)
