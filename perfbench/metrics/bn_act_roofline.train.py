"""Training's BN + activation kernels (csrc/bn_act.cu, the kernels whose
names hold ``bn_act``) against their roofline: the least time of the
traced steps' BN + activation (every BN conv's output in bf16 moved 10
bytes a value: y read and out written forward, g and y read and dy
written backward, at the HBM rate), over those kernels' device time, in
percent.  The BN convs are the frozen graph's (``reference.topology``);
the images come from the steps.  None without the kernels."""

from perfbench.harness import peaks, readers
from perfbench.reference import topology

KERNELS = ("bn_act",)
BYTES_PER_VALUE = 10


def bn_values(side: int, num_classes: int, depth) -> int:
    """Output values of one image's BN convs."""
    return sum(l.h_out * l.w_out * l.co
               for l in topology.conv_layers(side, num_classes, depth)
               if l.bn)


def read(ctx):
    if ctx.run.trace is None:
        return None
    spent = sum(e - s for _, s, e in readers.window_events(
        ctx, "kernel", KERNELS)) / 1e9
    if not spent:
        return None
    cfg = ctx.cell.config
    values = readers.images(ctx) * bn_values(
        cfg["img_size"], cfg["num_classes"], tuple(cfg["csp_repeats"]))
    least = values * BYTES_PER_VALUE / peaks.HBM_BYTES_PER_S
    return 100.0 * least / spent
