"""The port's label encoders (yolov4tpu_torch.data.encode) against the JAX
package's: the host encoder against the JAX host encoder, and the device
encoder (``encode_labels_torch``) against both.  Bit-identical: the same
float32 arithmetic on integral box centers, the same cell-index table, and
a dedup that makes collisions order-independent.
"""

import jax
import numpy as np
import pytest
import torch

from yolov4tpu.data import encode as jencode
from yolov4tpu_torch.data import encode as tencode

ANCHORS = np.array([12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72, 146, 142,
                    110, 192, 243, 459, 401], np.float32).reshape(9, 2)
C = 5


def _random_boxes(seed, bs=3, n=40, size=416):
    rng = np.random.default_rng(seed)
    boxes = np.zeros((bs, 100, 5), np.float32)
    for b in range(bs):
        xy = rng.integers(0, size - 8, (n, 2))
        wh = rng.integers(2, size // 2, (n, 2))
        x2y2 = np.minimum(xy + wh, size)
        boxes[b, :n] = np.concatenate(
            [xy, x2y2, rng.integers(0, C, (n, 1))], -1)
    return boxes


def _collisions_and_boundaries():
    """Boxes that share (cell, anchor) with different classes, and boxes
    centred on cell boundaries (264/416*52 rounds to 32.99999.. on the host,
    33 with a fused multiply) and on the image edge."""
    boxes = np.zeros((2, 100, 5), np.float32)
    boxes[0, 0] = [100, 100, 140, 130, 0]
    boxes[0, 1] = [101, 101, 141, 131, 3]     # the next column (x 121)
    boxes[0, 2] = [102, 99, 139, 131, 1]      # box 0's cell + anchor, later
    boxes[0, 3] = [244, 244, 284, 284, 2]     # centre 264: a boundary
    boxes[0, 4] = [240, 100, 288, 148, 4]     # centre x 264
    boxes[1, 0] = [392, 392, 416, 416, 1]     # centre 404, near the edge
    boxes[1, 1] = [400, 0, 416, 30, 2]        # centre x 408
    boxes[1, 2] = [0, 0, 416, 416, 3]         # whole image, centre 208
    boxes[1, 3] = [10, 200, 30, 232, 0]
    return boxes


CASES = {"random": lambda: _random_boxes(0),
         "collisions": _collisions_and_boundaries,
         "empty": lambda: np.zeros((2, 100, 5), np.float32)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_encoder_matches_jax_host(case):
    boxes = CASES[case]()
    want, want_xywh = jencode.preprocess_true_boxes(boxes, (416, 416),
                                                    ANCHORS, C)
    got, got_xywh = tencode.preprocess_true_boxes(boxes, (416, 416),
                                                  ANCHORS, C)
    np.testing.assert_array_equal(got_xywh, want_xywh)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", sorted(CASES))
def test_device_encoder_is_bit_identical(case):
    boxes = CASES[case]()
    host, host_xywh = jencode.preprocess_true_boxes(boxes, (416, 416),
                                                    ANCHORS, C)
    dev_j, dev_j_xywh = jax.jit(
        jencode.encode_labels_jax, static_argnums=(1, 3))(
            boxes, (416, 416), ANCHORS, C)
    got, got_xywh = tencode.encode_labels_torch(torch.from_numpy(boxes),
                                                (416, 416), ANCHORS, C)
    np.testing.assert_array_equal(got_xywh.numpy(), host_xywh)
    np.testing.assert_array_equal(got_xywh.numpy(), np.asarray(dev_j_xywh))
    for g, h, d in zip(got, host, dev_j):
        assert g.dtype == torch.float32 and g.shape == h.shape
        np.testing.assert_array_equal(g.numpy(), h)
        np.testing.assert_array_equal(g.numpy(), np.asarray(d))


def test_collision_keeps_last_box_and_all_classes():
    boxes = _collisions_and_boundaries()
    got, _ = tencode.encode_labels_torch(torch.from_numpy(boxes), (416, 416),
                                         ANCHORS, C)
    # Boxes 0 and 2 of image 0 share a (cell, anchor) — centre x 120 lands
    # in column 14, as 120/416*52 rounds below 15 on the host: the row holds
    # the last box's xy/wh and the flags of both classes (0 and 1).
    cell = got[0][0, 14, 14, 2].numpy()
    np.testing.assert_array_equal(cell[:5], [120, 115, 37, 32, 1])
    np.testing.assert_array_equal(cell[5:], [1, 1, 0, 0, 0])
    np.testing.assert_array_equal(got[0][0, 14, 15, 2, 5:].numpy(),
                                  [0, 0, 0, 1, 0])


def test_grid_index_table_matches_jax():
    for extent, g in [(416, 52), (416, 26), (416, 13), (64, 8), (608, 19)]:
        np.testing.assert_array_equal(tencode._grid_index_table(extent, g),
                                      jencode._grid_index_table(extent, g))
    # 264/416*52 is a boundary the host rounds down.
    assert tencode._grid_index_table(416, 52)[264] == 32
