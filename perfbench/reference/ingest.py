"""The tf.keras reference's training ingest (utils.py:121-207) for plain
batches: read the JPEG (OpenCV's decoder), BGR to RGB, stretch to the
input size by bilinear sampling with half-pixel centres, divide by 255,
and scale the boxes by (width ratio, height ratio) in float32.  The
resize is written out in float64 NumPy (OpenCV's own is fixed point)."""

from __future__ import annotations

import numpy as np


def read_rgb(path: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img[:, :, ::-1]


def _taps(src: int, dst: int):
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f)
    w = f - i0
    i0 = i0.astype(np.int64)
    return np.clip(i0, 0, src - 1), np.clip(i0 + 1, 0, src - 1), w


def resize(img: np.ndarray, side: int) -> np.ndarray:
    """uint8 (h, w, 3) -> float32 (side, side, 3) in [0, 1]."""
    h, w = img.shape[:2]
    y0, y1, wy = _taps(h, side)
    x0, x1, wx = _taps(w, side)
    f = img.astype(np.float64)
    top = f[y0] * (1 - wy)[:, None, None] + f[y1] * wy[:, None, None]
    out = top[:, x0] * (1 - wx)[None, :, None] + top[:, x1] * wx[None, :,
                                                                    None]
    return (out / 255.0).astype(np.float32)


def sample(path: str, boxes: np.ndarray, side: int):
    """One annotated image -> (image (side, side, 3), boxes scaled)."""
    img = read_rgb(path)
    h, w = img.shape[:2]
    boxes = np.asarray(boxes, np.float32).copy()
    boxes[:, [0, 2]] *= np.float32(side / w)
    boxes[:, [1, 3]] *= np.float32(side / h)
    return resize(img, side), boxes
