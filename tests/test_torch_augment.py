"""The port's training augmentations (``yolov4tpu_torch.data.pipeline``)
against the JAX package's on the same seeded numpy inputs and the same
``np.random.Generator`` state: ``random_hflip``, ``random_color_jitter``,
``mosaic4``, ``cutmix2``, ``read_image_rgb`` and ``load_and_resize`` with
letterbox and colour jitter.  The same cv2 calls in the same order, so
images, boxes and the generator's state after the call are equal bit for
bit.
"""

import cv2
import numpy as np
import pytest

from yolov4tpu.data import pipeline as jpipe
from yolov4tpu_torch.data import pipeline as tpipe


def _rgb(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _boxes(rng, h, w, n):
    x1 = rng.uniform(0, w * 0.6, n)
    y1 = rng.uniform(0, h * 0.6, n)
    x2 = np.minimum(x1 + rng.uniform(3, w * 0.5, n), w)
    y2 = np.minimum(y1 + rng.uniform(3, h * 0.5, n), h)
    cls = rng.integers(0, 3, n)
    return np.stack([x1, y1, x2, y2, cls], 1).astype(np.float32)


def _same(got, want):
    """Two (img, boxes) results equal in dtype, shape and value."""
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def _twin_rngs(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def _after(rng_a, rng_b):
    """Both generators were advanced alike: their next draws agree."""
    assert rng_a.integers(0, 2 ** 62) == rng_b.integers(0, 2 ** 62)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("kind", ["float", "uint8", "no boxes"])
def test_random_hflip_equals_jax(seed, kind):
    rng = np.random.default_rng(100 + seed)
    img = _rgb(rng, 37, 53)
    if kind == "float":
        img = img.astype(np.float32) / 255.0
    boxes = (np.zeros((0, 5), np.float32) if kind == "no boxes"
             else _boxes(rng, 37, 53, 4))
    a, b = _twin_rngs(seed)
    _same(tpipe.random_hflip(img, boxes, a), jpipe.random_hflip(img, boxes, b))
    _after(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_color_jitter_equals_jax(seed):
    rng = np.random.default_rng(200 + seed)
    img = _rgb(rng, 41, 29).astype(np.float32) / 255.0
    a, b = _twin_rngs(seed)
    got = tpipe.random_color_jitter(img, a)
    want = jpipe.random_color_jitter(img, b)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    _after(a, b)
    a, b = _twin_rngs(seed)
    np.testing.assert_array_equal(
        tpipe.random_color_jitter(img, a, hue=0.3, sat=1.0, val=0.2),
        jpipe.random_color_jitter(img, b, hue=0.3, sat=1.0, val=0.2))


@pytest.mark.parametrize("target", [(64, 64), (48, 80), (5, 5)])
@pytest.mark.parametrize("seed", [0, 1])
def test_mosaic4_equals_jax(target, seed):
    """Four tiles of different sizes (one with no boxes); at 5x5 some
    quadrants are under 2 px and are skipped."""
    rng = np.random.default_rng(300 + seed)
    samples = []
    for i, (h, w) in enumerate(((30, 40), (64, 48), (20, 70), (50, 50))):
        img = _rgb(rng, h, w).astype(np.float32) / 255.0
        boxes = (np.zeros((0, 5), np.float32) if i == 2
                 else _boxes(rng, h, w, 3))
        samples.append((img, boxes))
    a, b = _twin_rngs(seed)
    _same(tpipe.mosaic4(samples, target, a), jpipe.mosaic4(samples, target, b))
    _after(a, b)


@pytest.mark.parametrize("b_size", [(64, 64), (40, 90)])
@pytest.mark.parametrize("seed", [0, 1])
def test_cutmix2_equals_jax(b_size, seed):
    """Image B of A's size (pasted region copied) and of another size
    (resized into the region, its boxes rescaled)."""
    rng = np.random.default_rng(400 + seed)
    a_img = _rgb(rng, 64, 64).astype(np.float32) / 255.0
    b_img = _rgb(rng, *b_size).astype(np.float32) / 255.0
    sa = (a_img, _boxes(rng, 64, 64, 5))
    sb = (b_img, _boxes(rng, *b_size, 4))
    a, b = _twin_rngs(seed)
    _same(tpipe.cutmix2(sa, sb, a), jpipe.cutmix2(sa, sb, b))
    _after(a, b)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A JPEG, a PNG and a JPEG whose EXIF orientation tag is 6 (cv2
    rotates it; the native decoder refuses it)."""
    from test_native import _insert_exif_orientation
    folder = tmp_path_factory.mktemp("aug_images")
    rng = np.random.default_rng(5)
    img = _rgb(rng, 60, 90)
    paths = {"jpeg": folder / "a.jpg", "png": folder / "b.png",
             "exif": folder / "c.jpg"}
    cv2.imwrite(str(paths["jpeg"]), img)
    cv2.imwrite(str(paths["png"]), img[:50, :70])
    raw = paths["jpeg"].read_bytes()
    paths["exif"].write_bytes(_insert_exif_orientation(raw, 6))
    return {k: str(v) for k, v in paths.items()}


@pytest.mark.parametrize("native_decode", [False, True])
@pytest.mark.parametrize("kind", ["jpeg", "png", "exif"])
def test_read_image_rgb_equals_jax(images, kind, native_decode):
    got = tpipe.read_image_rgb(images[kind], native_decode=native_decode)
    want = jpipe.read_image_rgb(images[kind], native_decode=native_decode)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if kind == "exif":
        assert got.shape[:2] == (90, 60)      # rotated by cv2 in both
    with pytest.raises(FileNotFoundError):
        tpipe.read_image_rgb(images[kind] + ".missing",
                             native_decode=native_decode)


@pytest.mark.parametrize("native_decode", [False, True])
@pytest.mark.parametrize("jitter", [False, True])
@pytest.mark.parametrize("letterbox", [False, True])
def test_load_and_resize_equals_jax(images, letterbox, jitter,
                                    native_decode):
    boxes = np.array([[5, 4, 40, 30, 1], [50, 10, 88, 59, 0]], np.float32)
    a, b = _twin_rngs(7)
    kw = dict(letterbox=letterbox, native_decode=native_decode)
    got = tpipe.load_and_resize(images["jpeg"], (48, 64), boxes,
                                color_jitter_rng=a if jitter else None, **kw)
    want = jpipe.load_and_resize(images["jpeg"], (48, 64), boxes,
                                 color_jitter_rng=b if jitter else None, **kw)
    _same(got, want)
    _after(a, b)
    if letterbox:
        # Jitter runs on the raw image, so the bars stay exactly gray.
        s, dx, dy = tpipe.letterbox_transform((60, 90), (48, 64))
        assert dy > 0 and (got[0][:dy] == 0.5).all()
