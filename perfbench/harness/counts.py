"""The work counts of the yardstick, from the frozen graph
(``reference.topology``), never from the program: the model's FLOPs, the
3x3 stride-1 weight gradients' least times, and the NMS problem's least
time."""

from __future__ import annotations

import collections

from . import peaks
from ..reference import topology


def model_flops(side: int, num_classes: int = 80,
                depth=topology.DEPTH) -> float:
    """2 x the multiply-adds of the graph's convolutions for one image at
    ``side`` pixels (BN, activations, pools and the decode not counted)."""
    return float(sum(2 * l.h_out * l.w_out * l.k * l.k * l.ci * l.co
                     for l in topology.conv_layers(side, num_classes, depth)))


def wgrad_shapes(side: int, num_classes: int = 80, depth=topology.DEPTH):
    """Counter of (H, Ci, Co) over the 3x3 stride-1 convs."""
    return collections.Counter(
        (l.h_out, l.ci, l.co)
        for l in topology.conv_layers(side, num_classes, depth)
        if l.k == 3 and not l.down)


def wgrad_least_s(batch: int, side: int, num_classes: int = 80,
                  depth=topology.DEPTH) -> float:
    """The least time of one step's 3x3 stride-1 weight gradients in
    bfloat16: per conv the larger of its 2*9*B*H*W*Ci*Co operations at the
    tensor cores' peak and its bytes (x and dy in bf16 read once, the
    float32 result written once) at the HBM rate."""
    total = 0.0
    for (h, ci, co), n in wgrad_shapes(side, num_classes, depth).items():
        ops = 2 * 9 * batch * h * h * ci * co
        nbytes = batch * h * h * (ci + co) * 2 + 9 * ci * co * 4
        total += n * max(ops / peaks.BF16_FLOPS,
                         nbytes / peaks.HBM_BYTES_PER_S)
    return total


def nms_least_s(work: dict) -> float:
    """The least time of an NMS problem counted as {"bytes", "tests"}: the
    bytes at the HBM rate or the IoU tests at the float32 rate."""
    return max(work["bytes"] / peaks.HBM_BYTES_PER_S,
               work["tests"] * peaks.IOU_OPS / peaks.F32_FLOPS)
