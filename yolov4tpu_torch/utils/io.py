"""Annotation file IO (reference utils.py:469-475): a copy of the parts of
``yolov4tpu.utils.io`` the evaluation path reads.

Annotation line format (reference README.md:84-93):
    img_name.jpg x1,y1,x2,y2,class_id x1,y1,x2,y2,class_id ...
"""

from __future__ import annotations

from typing import List


def read_txt_to_list(path: str) -> List[str]:
    """File -> stripped lines (reference utils.py:469-475)."""
    with open(path) as f:
        return [x.strip() for x in f.readlines()]


def parse_annotation_line(line: str):
    """One annotation line -> (img_name, [[x1,y1,x2,y2,cls], ...])."""
    parts = line.split()
    boxes = [[float(v) for v in b.split(",")] for b in parts[1:]]
    return parts[0], boxes
