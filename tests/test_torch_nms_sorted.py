"""The port's sorted NMS path (``nms_impl="pallas"``) against the JAX
package's, on the same numpy inputs.

``suppress_reference`` — the plain torch version of the CUDA kernel
``csrc/suppress.cu``, which ``suppress`` runs for CPU tensors — is held to
the Pallas kernel ``_suppress_kernel`` run in interpret mode: ``keep``
exactly equal on prefix masks, a non-prefix mask, all-valid and empty
masks, C in {1, 3, 8} and K in {32, 252}.  Then ``combined_nms_sorted``
against ``combined_nms_pallas`` and the exact ``combined_nms``, and
``ops.nms.nms(use_pallas=True)`` against the JAX package's.  (The CUDA
kernel itself is compared with ``suppress_reference`` on the card by
chip_smoke.py.)
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import IMG, assert_detections_equal
from yolov4tpu.config import YoloConfig
from yolov4tpu.models import head as jhead
from yolov4tpu.ops.nms import nms as jax_nms
from yolov4tpu.ops import nms_pallas as jpallas
from yolov4tpu_torch.models import head as thead
from yolov4tpu_torch.ops import nms as tnms
from yolov4tpu_torch.ops import nms_cuda


def _boxes(rng, shape):
    """Clustered corner boxes in [0, 1] (many overlaps), some with their
    corners swapped."""
    n = int(np.prod(shape))
    centers = rng.uniform(0.2, 0.8, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 0.02, (n, 2))
    wh = rng.uniform(0.05, 0.25, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], axis=-1)
    swap = rng.uniform(size=n) < 0.1
    boxes[swap] = boxes[swap][:, [2, 3, 0, 1]]
    return np.clip(boxes, 0, 1).astype(np.float32).reshape(*shape, 4)


def _sorted_inputs(rng, b, c, k, mask):
    """The kernel's inputs as numpy: coords (B,4,C,K) with lo <= hi and a
    0/1 valid mask (B,C,K) of the given kind."""
    boxes = _boxes(rng, (b, c, k))
    lo = np.minimum(boxes[..., :2], boxes[..., 2:])
    hi = np.maximum(boxes[..., :2], boxes[..., 2:])
    coords = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], 1)
    if mask == "prefix":      # descending scores above a threshold
        counts = rng.integers(0, k + 1, (b, c, 1))
        valid = np.arange(k)[None, None] < counts
    elif mask == "non-prefix":
        valid = rng.uniform(size=(b, c, k)) < 0.5
    elif mask == "all":
        valid = np.ones((b, c, k), bool)
    else:
        valid = np.zeros((b, c, k), bool)
    return np.ascontiguousarray(coords), valid.astype(np.float32)


def _pallas(coords, valid, iou_t):
    return np.asarray(jpallas._suppress_batch(
        jnp.asarray(coords), jnp.asarray(valid), iou_t, interpret=True))


@pytest.mark.parametrize("b,c,k,iou_t,mask", [
    (2, 3, 32, 0.413, "prefix"),
    (2, 8, 32, 0.413, "non-prefix"),
    (2, 1, 252, 0.5, "prefix"),       # K not a multiple of 32
    (2, 3, 252, 0.413, "non-prefix"),
    (2, 8, 32, 0.3, "all"),
    (2, 3, 32, 0.413, "empty"),
])
def test_suppress_reference_matches_pallas(rng, b, c, k, iou_t, mask):
    coords, valid = _sorted_inputs(rng, b, c, k, mask)
    want = _pallas(coords, valid, iou_t)
    args = torch.from_numpy(coords), torch.from_numpy(valid)
    got = nms_cuda.suppress_reference(*args, iou_t)
    assert got.dtype == torch.float32 and got.shape == (b, c, k)
    np.testing.assert_array_equal(got.numpy(), want)
    # On CPU tensors the kernel's wrapper runs exactly this plain version.
    launches = nms_cuda.SUPPRESS_LAUNCHES
    np.testing.assert_array_equal(nms_cuda.suppress(*args, iou_t).numpy(),
                                  want)
    assert nms_cuda.SUPPRESS_LAUNCHES == launches
    assert not (want > valid).any()
    if mask == "empty":
        assert not want.any()
    if mask in ("prefix", "all"):
        assert (want < valid).any()       # something was suppressed
    if mask == "non-prefix":
        # Looping to each image's largest valid count, not to K, matters
        # on this mask: with one all-valid class added (bound K) the other
        # classes come out differently.
        full = np.concatenate([valid, np.ones((b, 1, k), np.float32)], 1)
        coords_full = np.concatenate([coords, coords[:, :, :1]], 2)
        longer = nms_cuda.suppress_reference(
            torch.from_numpy(coords_full), torch.from_numpy(full), iou_t)
        assert not np.array_equal(longer[:, :c].numpy(), want)


def test_suppress_empty_batch_and_limits(rng):
    coords, valid = _sorted_inputs(rng, 1, 2, 32, "prefix")
    coords, valid = torch.from_numpy(coords), torch.from_numpy(valid)
    empty = nms_cuda.suppress(coords[:0], valid[:0], 0.4)
    assert tuple(empty.shape) == (0, 2, 32)
    with pytest.raises(TypeError):
        nms_cuda.suppress(coords.double(), valid, 0.4)
    with pytest.raises(ValueError):
        nms_cuda.suppress(coords[:, :3], valid, 0.4)
    with pytest.raises(ValueError):
        nms_cuda.suppress(coords, valid[:, :1], 0.4)
    big = torch.zeros(1, 4, 1, 1025), torch.zeros(1, 1, 1025)
    with pytest.raises(ValueError, match="1024"):
        nms_cuda.suppress(*big, 0.4)


def _scored_boxes(rng, b, n, c):
    boxes = _boxes(rng, (b, n))
    scores = rng.uniform(0, 1, (b, n, c)).astype(np.float32)
    return boxes, scores


@pytest.mark.parametrize("n,c,iou_t,score_t,k,max_per_class,max_total", [
    (64, 3, 0.413, 0.3, 64, 100, 100),
    (96, 5, 0.5, 0.1, 64, 100, 100),
    (48, 1, 0.3, 0.05, 32, 100, 100),
    (40, 2, 0.413, 0.3, 40, 5, 8),     # the caps bite
    (6, 1, 0.413, 0.05, 8, 100, 10),   # K = 6 < max_total: padded output
])
def test_combined_nms_sorted_matches_jax(rng, n, c, iou_t, score_t, k,
                                         max_per_class, max_total):
    boxes, scores = _scored_boxes(rng, 2, n, c)
    kw = dict(iou_threshold=iou_t, score_threshold=score_t,
              max_per_class=max_per_class, max_total=max_total, pre_top_k=k)
    want = jpallas.combined_nms_pallas(jnp.asarray(boxes),
                                       jnp.asarray(scores), interpret=True,
                                       **kw)
    got = nms_cuda.combined_nms_sorted(torch.from_numpy(boxes),
                                       torch.from_numpy(scores), **kw)
    assert got[3].dtype == torch.int32
    assert tuple(got[0].shape) == (2, max_total, 4)
    got_np = [o.numpy() for o in got]
    want_np = [np.asarray(o) for o in want]
    np.testing.assert_array_equal(got_np[3], want_np[3])
    np.testing.assert_array_equal(got_np[2], want_np[2])
    np.testing.assert_allclose(got_np[1], want_np[1], rtol=1e-6)
    np.testing.assert_allclose(got_np[0], want_np[0], rtol=1e-6, atol=1e-7)
    # The sorted path is exact: it equals the plain per-class NMS.
    exact = tnms.combined_nms(torch.from_numpy(boxes),
                              torch.from_numpy(scores), **kw)
    assert_detections_equal(got, exact, box_atol=0, score_atol=0)
    assert got_np[3].min() > 0
    if max_per_class < 100:
        assert got_np[3].max() == max_total


def test_nms_entry_point_matches_jax(rng):
    """ops.nms.nms(use_pallas=True) on decoded heads, in both packages."""
    cfg, c = YoloConfig(img_size=(IMG, IMG, 3)), 4
    raws = [rng.normal(0, 1.5, (2, g, g, 3 * (5 + c))).astype(np.float32)
            for g in cfg.grid_sizes()]
    args = (cfg.anchors_grouped, c, cfg.strides, cfg.xyscale)
    jouts = jhead.decode_head([jnp.asarray(r) for r in raws], *args)
    touts = thead.decode_head([torch.from_numpy(r) for r in raws], *args)
    for use_pallas in (True, False):
        kw = dict(score_threshold=0.2, max_total=20, pre_top_k=64,
                  use_pallas=use_pallas)
        want = jax_nms(jouts, cfg.img_size, c, **kw)
        got = tnms.nms(touts, cfg.img_size, c, **kw)
        assert np.asarray(want[3]).min() > 0
        assert_detections_equal(got, want, box_atol=1e-6, score_atol=1e-6)
