"""The port's letterbox geometry (data.pipeline) and its unmapping in
``get_detection_data`` against the JAX package's, on the same numpy inputs:
exactly equal for tall, wide and square images."""

import numpy as np
import pandas as pd
import pytest

from yolov4tpu.data import pipeline as jpipe
from yolov4tpu.utils.visualize import get_detection_data as jax_detection_data
from yolov4tpu_torch.data import pipeline as tpipe
from yolov4tpu_torch.utils.visualize import get_detection_data

SHAPES = [(100, 200), (400, 100), (64, 64), (333, 517)]   # wide, tall, square


@pytest.mark.parametrize("raw_hw", SHAPES)
@pytest.mark.parametrize("target_hw", [(64, 64), (416, 416)])
def test_letterbox_transform_matches_jax(raw_hw, target_hw):
    assert (tpipe.letterbox_transform(raw_hw, target_hw)
            == jpipe.letterbox_transform(raw_hw, target_hw))


@pytest.mark.parametrize("raw_hw", SHAPES)
@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_letterbox_resize_and_unmap_match_jax(rng, raw_hw, dtype):
    img = rng.uniform(0, 255, (*raw_hw, 3)).astype(dtype)
    h, w = raw_hw
    boxes = np.array([[0, 0, w, h, 1], [w * 0.2, h * 0.3, w * 0.6, h * 0.9, 0]],
                     np.float32)
    got = tpipe.letterbox_resize(img, (64, 64), boxes)
    want = jpipe.letterbox_resize(img, (64, 64), boxes)
    assert got[0].dtype == np.float32 and got[0].shape == (64, 64, 3)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    # No boxes: the empty array passes through.
    assert tpipe.letterbox_resize(img, (64, 64), np.zeros((0, 5)))[1].shape \
        == (0, 5)

    norm = rng.uniform(-0.1, 1.1, (2, 7, 4)).astype(np.float32)
    unmapped = tpipe.letterbox_unmap(norm, got[2], (64, 64), raw_hw)
    np.testing.assert_array_equal(
        unmapped, jpipe.letterbox_unmap(norm, want[2], (64, 64), raw_hw))
    assert unmapped[..., [0, 2]].max() <= w and unmapped.min() >= 0


@pytest.mark.parametrize("raw_hw", SHAPES)
@pytest.mark.parametrize("letterbox", [True, False])
def test_get_detection_data_matches_jax(rng, raw_hw, letterbox):
    raw = np.zeros((*raw_hw, 3), np.uint8)
    n = 5
    boxes = np.zeros((1, 10, 4), np.float32)
    lo = rng.uniform(0, 0.6, (n, 2))
    boxes[0, :n] = np.concatenate([lo, lo + rng.uniform(0.05, 0.4, (n, 2))],
                                  -1)
    scores = np.zeros((1, 10), np.float32)
    scores[0, :n] = rng.uniform(0.3, 1, n)
    classes = np.zeros((1, 10), np.float32)
    classes[0, :n] = rng.integers(0, 3, n)
    outputs = (boxes, scores, classes, np.array([n], np.int32))
    transform = None
    if letterbox:
        transform = (tpipe.letterbox_transform(raw_hw, (64, 64)), (64, 64))
    names = ["a", "b", "c"]
    got = get_detection_data(raw, outputs, names,
                             letterbox_transform=transform)
    want = jax_detection_data(raw, outputs, names,
                              letterbox_transform=transform)
    assert len(got) == n
    pd.testing.assert_frame_equal(got, want)
