"""Annotation file IO (reference utils.py:80-86, 469-475): a copy of
``yolov4tpu.utils.io``.

Annotation line format (reference README.md:84-93):
    img_name.jpg x1,y1,x2,y2,class_id x1,y1,x2,y2,class_id ...
"""

from __future__ import annotations

import math
import numbers
from typing import List, Optional

import numpy as np


def read_annotation_lines(annotation_path: str,
                          test_size: Optional[float] = None,
                          random_seed: int = 5566, shard=None):
    """Read annotation lines, optionally returning a seeded (train, val)
    split (reference utils.py:80-86: sklearn's ``train_test_split`` with
    seed 5566, reproduced here in numpy: a ``RandomState(seed)``
    permutation whose first ``ceil(test_size * n)`` indices are the
    validation part, or ``test_size`` of them when it is an integer, numpy's
    included).

    ``shard=(rank, size)`` keeps every size-th line from ``rank`` on: the
    per-host data recipe, where each rank feeds its own generator.
    Applied after the split, so every rank shards the same seeded split.
    """
    with open(annotation_path) as f:
        lines = f.readlines()

    def _shard(ls):
        if shard is None:
            return ls
        pid, n = shard
        if not 0 <= pid < n:
            raise ValueError(f"shard process_id {pid} not in [0, {n})")
        return ls[pid::n]

    if test_size:
        n = len(lines)
        n_test = (int(test_size) if isinstance(test_size, numbers.Integral)
                  else math.ceil(test_size * n))
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} leaves an empty part "
                             f"of {n} lines")
        perm = np.random.RandomState(random_seed).permutation(n)
        train = [lines[i] for i in perm[n_test:]]
        val = [lines[i] for i in perm[:n_test]]
        return _shard(train), _shard(val)
    return _shard(lines)


def read_txt_to_list(path: str) -> List[str]:
    """File -> stripped lines (reference utils.py:469-475)."""
    with open(path) as f:
        return [x.strip() for x in f.readlines()]


def parse_annotation_line(line: str):
    """One annotation line -> (img_name, [[x1,y1,x2,y2,cls], ...])."""
    parts = line.split()
    boxes = [[float(v) for v in b.split(",")] for b in parts[1:]]
    return parts[0], boxes
