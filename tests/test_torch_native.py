"""The port's native host-pipeline library (``yolov4tpu_torch.native``, built
from ``yolov4tpu_torch/csrc/yolodata.cpp`` into ``build/torch_native/``)
against the JAX package's (``yolov4tpu.native``): every function bit-equal
on the same inputs (the same source, compiler and flags), and the port's
``DataGenerator(use_native=True)`` bit-equal to the JAX package's on the
fused plain ingest, the native augmented ingest and the per-sample Python
redo of PNG and EXIF-rotated files.  Also: where the library is built and
loaded from, which variant, and concurrent first builds.
"""

import pathlib
import subprocess
import sys

import cv2
import numpy as np
import pytest

from test_native import _insert_exif_orientation
from test_torch_data_aug import assert_batches_equal
from yolov4tpu import native as jnative
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.data.pipeline import DataGenerator as JaxGenerator
from yolov4tpu_torch import native
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data import pipeline as tpipe
from yolov4tpu_torch.data.pipeline import DataGenerator

REPO = pathlib.Path(__file__).resolve().parents[1]
IMG = 64


def _photo(rng, h, w):
    """A smooth raster (JPEG-friendly) of h x w."""
    coarse = rng.uniform(0, 255, (max(h // 16, 2), max(w // 16, 2), 3))
    img = cv2.resize(coarse.astype(np.float32), (w, h))
    img += rng.normal(0, 8, img.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def write_photos(folder, n, seed, extra=()):
    """n JPEGs of 100-300 px a side (DCT scaling applies at 64 px) with 1-4
    boxes each, plus the (name, kind) files of ``extra``: kind "png" or
    "exif" (a JPEG whose EXIF orientation is 6).  Returns the lines."""
    rng = np.random.default_rng(seed)
    names = [(f"p{i}.jpg", "jpeg") for i in range(n)] + list(extra)
    lines = []
    for name, kind in names:
        h, w = int(rng.integers(100, 300)), int(rng.integers(100, 300))
        img = _photo(rng, h, w)
        path = folder / name
        if kind == "exif":
            cv2.imwrite(str(path), img)
            path.write_bytes(_insert_exif_orientation(path.read_bytes(), 6))
            h, w = w, h              # boxes in the displayed (rotated) frame
        else:
            cv2.imwrite(str(path), img)
        boxes = []
        for _ in range(int(rng.integers(1, 5))):
            x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            x2 = int(rng.integers(x1 + 8, w))
            y2 = int(rng.integers(y1 + 8, h))
            boxes.append(f"{x1},{y1},{x2},{y2},{int(rng.integers(0, 3))}")
        lines.append(f"{name} " + " ".join(boxes))
    return lines


@pytest.fixture(scope="module")
def photos(tmp_path_factory):
    folder = tmp_path_factory.mktemp("photos")
    return folder, write_photos(folder, 6, seed=2)


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    folder = tmp_path_factory.mktemp("mixed")
    return folder, write_photos(folder, 4, seed=3,
                                extra=[("q.png", "png"), ("r.jpg", "exif")])


def test_library_lies_in_the_port_and_is_its_own():
    assert native.available() and native.has_jpeg()
    assert native.build_variant() == "openmp+libjpeg"
    assert [name for name, _ in native.VARIANTS] == [
        "openmp+libjpeg", "libjpeg", "openmp", "plain"]
    path = native.library_path()
    assert path.parent == REPO / "build" / "torch_native"
    assert path.name.startswith("yolodata-") and path.suffix == ".so"
    assert path == native.variant_path(native.VARIANTS[0][1])
    assert native.SRC == REPO / "yolov4tpu_torch" / "csrc" / "yolodata.cpp"
    assert native.num_threads() == jnative.num_threads() >= 1


_BUILD_SCRIPT = """
import pathlib, sys
from yolov4tpu_torch import native
native.BUILD_DIR = pathlib.Path(sys.argv[1])
ok = native.available() and native.has_jpeg()
maps = pathlib.Path("/proc/self/maps").read_text()
print(ok, native.build_variant(), native.library_path(),
      "native/build/libyolodata" in maps, "jax" in sys.modules)
"""


def test_concurrent_first_builds(tmp_path):
    """Three processes build the library into an empty directory at once:
    each loads the same file, no temporary file is left, and none loads the
    JAX package's library or imports JAX."""
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT,
                               str(tmp_path)], cwd=REPO, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for _ in range(3)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    lines = {out.strip() for out, _ in outs}
    assert len(lines) == 1, lines
    ok, variant, path, jax_lib, jax_mod = lines.pop().split()
    assert (ok, variant, jax_lib, jax_mod) == ("True", "openmp+libjpeg",
                                               "False", "False")
    assert pathlib.Path(path).parent == tmp_path
    assert sorted(p.suffix for p in tmp_path.iterdir()) == [".log", ".so"]


def test_flags_and_source_key_the_library():
    first = native.variant_path(native.VARIANTS[0][1])
    assert native.variant_path(native.VARIANTS[1][1]) != first
    assert native.variant_path(native.VARIANTS[0][1]) == first


# -- every function against yolov4tpu.native ---------------------------------

def _u8(rng, shapes):
    return [rng.integers(0, 256, (h, w, 3), dtype=np.uint8) for h, w in shapes]


def _box_batch(rng, bs, mb, hw):
    boxes = np.zeros((bs, mb, 5), np.float32)
    for b in range(bs):
        n = int(rng.integers(1, mb))
        x1 = rng.uniform(0, hw[1] * 0.8, n)
        y1 = rng.uniform(0, hw[0] * 0.8, n)
        boxes[b, :n] = np.stack(
            [x1, y1, np.minimum(x1 + rng.uniform(4, 120, n), hw[1] - 1),
             np.minimum(y1 + rng.uniform(4, 120, n), hw[0] - 1),
             rng.integers(0, 3, n)], -1)
    return boxes


def _equal(got, want):
    if isinstance(want, (list, tuple)):
        assert isinstance(got, (list, tuple)) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif want is None:
        assert got is None
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _calls(photos):
    folder, lines = photos
    rng = np.random.default_rng(11)
    jpgs = [str(folder / line.split()[0]) for line in lines]
    png = str(folder / "plain.png")
    cv2.imwrite(png, _photo(rng, 70, 90))
    imgs = _u8(rng, [(100, 80), (37, 53), (64, 64)])
    anchors = np.asarray(YoloConfig().anchors_flat, np.float32)
    boxes = _box_batch(rng, 4, 12, (416, 416))
    src_boxes = _box_batch(rng, 3, 6, (100, 100))
    paths = [jpgs[0], png, jpgs[1]]
    # A mosaic sample (4 tiles), a letterbox sample and a plain one with
    # jitter; samples 0 and 2 flipped.
    tiles = [jpgs[0], jpgs[1], jpgs[2], jpgs[3], jpgs[4], jpgs[5]]
    sample = np.array([0, 0, 0, 0, 1, 2])
    rect = np.array([[0, 0, 20, 30], [20, 0, 44, 30], [0, 30, 20, 34],
                     [20, 30, 44, 34], [0, 10, 64, 44], [0, 0, 64, 64]])
    hsv = np.array([[12.5, 1.3, 0.8], [0, -1, 1], [-30, 0.7, 1.2],
                    [0, -1, 1], [5, 1.1, 1.1], [100, 0.9, 1.4]], np.float32)
    flip = np.array([1, 0, 1], np.uint8)
    fill = np.array([0.0, 0.5, 0.0], np.float32)
    return {
        "resize_bilinear_batch": ((imgs, (48, 40)), {}),
        "encode_labels_batch": ((boxes, (416, 416), anchors, 3), {}),
        "encode_labels_batch 320x384": ((boxes, (320, 384), anchors, 80), {}),
        "assemble_batch": ((imgs, src_boxes, (48, 48)), {}),
        "imread": ((jpgs[0],), {}),
        "imread min_hw": ((jpgs[1],), {"min_hw": (30, 20)}),
        "imread png": ((png,), {}),
        "probe_dims": ((jpgs[2],), {}),
        "probe_dims png": ((png,), {}),
        "ingest_batch": ((paths, src_boxes, (64, 64)), {}),
        "ingest_batch exact": ((paths, src_boxes, (64, 48)),
                               {"dct_scale": False}),
        "ingest_aug_batch": ((tiles, sample, rect, hsv, flip, fill, 3,
                              (64, 64)), {}),
        "ingest_aug_batch exact": ((tiles, sample, rect, hsv, flip, fill, 3,
                                    (64, 64)), {"dct_scale": False}),
    }


CALLS = ["resize_bilinear_batch", "encode_labels_batch",
         "encode_labels_batch 320x384", "assemble_batch", "imread",
         "imread min_hw", "imread png", "probe_dims", "probe_dims png",
         "ingest_batch", "ingest_batch exact", "ingest_aug_batch",
         "ingest_aug_batch exact"]


@pytest.mark.parametrize("call", CALLS)
def test_function_equals_jax(photos, call):
    args, kw = _calls(photos)[call]
    name = call.split()[0]
    _equal(getattr(native, name)(*args, **kw),
           getattr(jnative, name)(*args, **kw))


def test_counters_count_the_fused_ingests(photos):
    args, kw = _calls(photos)["ingest_batch"]
    plain, aug = native.NATIVE_BATCHES, native.NATIVE_AUG_BATCHES
    native.ingest_batch(*args, **kw)
    assert (native.NATIVE_BATCHES, native.NATIVE_AUG_BATCHES) == (plain + 1,
                                                                  aug)
    args, kw = _calls(photos)["ingest_aug_batch"]
    native.ingest_aug_batch(*args, **kw)
    assert (native.NATIVE_BATCHES, native.NATIVE_AUG_BATCHES) == (plain + 1,
                                                                  aug + 1)
    with pytest.raises(ValueError, match="tiles"):
        native.ingest_aug_batch(args[0], args[1][:-1], *args[2:])


# -- DataGenerator(use_native=True) against the JAX package's ---------------

GEN_OPTIONS = {
    "plain": dict(),
    "plain exact decode": dict(fast_decode=False),
    "plain encode_on_device uint8": dict(encode_on_device=True,
                                         transfer_uint8=True),
    "mosaic+hflip+jitter": dict(use_mosaic=True, use_hflip=True,
                                use_color_jitter=True),
    "letterbox+hflip": dict(letterbox=True, use_hflip=True),
    "jitter": dict(use_color_jitter=True),
    "multi-scale mosaic": dict(use_mosaic=True, multi_scale=(32, 128),
                               multi_scale_interval=1),
}


def native_pair(data, tiny_classes, seed=5, **cfg):
    """(port generator, JAX generator), both native, same lines and seed."""
    folder, lines = data
    kw = dict(img_size=(IMG, IMG, 3), batch_size=3, num_workers=2, **cfg)
    tgen = DataGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                         config=YoloConfig(**kw), seed=seed)
    jgen = JaxGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                        config=JaxConfig(**kw), seed=seed)
    return tgen, jgen


def counts():
    return (native.NATIVE_BATCHES, native.NATIVE_AUG_BATCHES,
            tpipe.PYTHON_BATCHES, tpipe.PYTHON_REDO_SAMPLES)


@pytest.mark.parametrize("name", sorted(GEN_OPTIONS))
def test_native_generator_equals_jax(photos, tiny_classes, name):
    opts = GEN_OPTIONS[name]
    tgen, jgen = native_pair(photos, tiny_classes, **opts)
    assert tgen.use_native and jgen.use_native
    before = counts()
    batches = 0
    for _ in range(2):
        for i in range(len(tgen)):
            assert_batches_equal(tgen.get_batch(i), jgen.get_batch(i))
            batches += 1
        tgen.on_epoch_end()
        jgen.on_epoch_end()
    after = counts()
    aug = any(opts.get(k) for k in ("use_mosaic", "letterbox", "use_hflip",
                                    "use_color_jitter"))
    want = ((0, batches) if aug else (batches, 0)) + (0, 0)
    assert tuple(a - b for a, b in zip(after, before)) == want


def test_native_geometry_equals_the_python_path(photos, tiny_classes):
    """The native augmented ingest's boxes and label grids are bit-equal to
    the Python path's; its pixels differ boundedly (one resize, jitter
    after it)."""
    for opts in (GEN_OPTIONS["mosaic+hflip+jitter"],
                 GEN_OPTIONS["letterbox+hflip"], GEN_OPTIONS["jitter"]):
        nat, _ = native_pair(photos, tiny_classes, **opts)
        py = DataGenerator(nat.annotation_lines, tiny_classes,
                           nat.folder_path, max_boxes=10, config=nat.config,
                           seed=5, use_native=False)
        for i in range(len(nat)):
            bn, bp = nat.get_batch(i), py.get_batch(i)
            np.testing.assert_array_equal(bn["boxes"], bp["boxes"])
            for ln, lp in zip(bn["labels"], bp["labels"]):
                np.testing.assert_array_equal(ln, lp)
            assert float(np.abs(bn["image"] - bp["image"]).mean()) < 0.08


@pytest.mark.parametrize("aug", ["mosaic+hflip+jitter", "letterbox+hflip"])
def test_png_and_exif_samples_are_redone_in_python(mixed, tiny_classes, aug):
    """A PNG and an EXIF-rotated JPEG cannot take the native decode: their
    samples are redone in Python from the same seed, so the batch equals
    the JAX package's, and its geometry equals the Python path's."""
    opts = GEN_OPTIONS[aug]
    tgen, jgen = native_pair(mixed, tiny_classes, seed=1, **opts)
    folder, lines = mixed
    py = DataGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                       config=tgen.config, seed=1, use_native=False)
    before = counts()
    for i in range(len(tgen)):
        got, want, ref = tgen.get_batch(i), jgen.get_batch(i), py.get_batch(i)
        assert_batches_equal(got, want)
        np.testing.assert_array_equal(got["boxes"], ref["boxes"])
    redone = counts()[3] - before[3]
    # Every sample whose tiles include q.png or r.jpg is redone: at least
    # the two samples that hold them as their own image.
    assert redone >= 2
    assert counts()[1] - before[1] == len(tgen)


@pytest.mark.parametrize("name", ["plain", "mosaic+hflip+jitter"])
def test_build_without_libjpeg_equals_jax(photos, tiny_classes, monkeypatch,
                                          name):
    """A host whose library has no libjpeg (the ``openmp`` variant): plain
    batches decode with cv2 (in the worker pool) and resize natively,
    augmented ones take the Python pool, bit-equal to the JAX package's on
    such a host."""
    assert native.available() and jnative.available()
    monkeypatch.setattr(native, "_jpeg_api", False)
    monkeypatch.setattr(jnative, "_jpeg_api", False)
    tgen, jgen = native_pair(photos, tiny_classes, **GEN_OPTIONS[name])
    before = counts()
    for i in range(len(tgen)):
        assert_batches_equal(tgen.get_batch(i), jgen.get_batch(i))
    d = tuple(a - b for a, b in zip(counts(), before))
    assert d == ((0, 0, 0, 0) if name == "plain" else (0, 0, len(tgen), 0))
    assert tgen._pool is not None


def test_pool_decode_equals_sequential_decode(photos):
    import concurrent.futures
    args, kw = _calls(photos)["ingest_batch"]
    want = native.ingest_batch(*args, **kw)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        got = native.ingest_batch(*args, decode_map=pool.map, **kw)
    _equal(got, want)
