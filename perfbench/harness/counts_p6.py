"""The work counts of YOLOv4-P6's yardsticks, from the reference's conv
list (``reference.scaled_yolov4``), never from the program: its FLOPs
and the bytes of its second-stage epilogues."""

from __future__ import annotations

from . import peaks
from ..reference import scaled_yolov4

MERGE_SITES = 7  # second-stage epilogues a P6 forward (reference's count)


def p6_flops(side: int, num_classes: int = 80,
             depth=scaled_yolov4.DEPTH) -> float:
    """2 x the multiply-adds of P6's convolutions for one image."""
    return scaled_yolov4.model_flops(side, num_classes, depth)


def merge_bytes(images: int, side: int, num_classes: int = 80,
                depth=scaled_yolov4.DEPTH, elem: int = 2) -> float:
    """The least bytes of one forward's second-stage epilogues over
    ``images`` images: each value of the 7 sites read once and written
    once, ``elem`` bytes each, and each site's (b, s, t) read once."""
    sites = scaled_yolov4.second_stage_sites(side, num_classes, depth)
    values = sum(c * h * w for c, h, w in sites)
    return float(2 * elem * images * values
                 + sum(3 * elem * c for c, _, _ in sites))


def merge_least_s(images: int, side: int, num_classes: int = 80,
                  depth=scaled_yolov4.DEPTH) -> float:
    """``merge_bytes`` (bf16) at the HBM rate."""
    return merge_bytes(images, side, num_classes, depth) / \
        peaks.HBM_BYTES_PER_S

