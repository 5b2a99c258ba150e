"""ctypes bindings for the port's native host-pipeline library
(``yolov4tpu_torch/csrc/yolodata.cpp``).

The library has a plain C ABI.  It is built at first use with g++ into
``build/torch_native/`` at the root of the checkout, keyed by a hash of the
source and the flags (``ops.build.digest``), through the same compile step
as the CUDA kernels (``ops.build.compile_to``: a file of this process moved
into place, so concurrent first builds are safe).  Four variants are tried
in order (``VARIANTS``): OpenMP and libjpeg, libjpeg alone, OpenMP without
JPEG decode, neither; ``build_variant()`` names the one that loaded.  When
none builds, ``available()`` is False and every entry point has a numpy/cv2
fallback, so the pipeline works (slower) on hosts without a toolchain.

``NATIVE_BATCHES`` and ``NATIVE_AUG_BATCHES`` count the batches that the
library's fused ingests (``yolo_ingest_batch``, ``yolo_ingest_aug_batch``)
produced, where the call is made and nowhere else.

Usage: ``from yolov4tpu_torch import native; native.available()`` then
``native.ingest_batch`` / ``native.ingest_aug_batch`` /
``native.encode_labels_batch`` / ...
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .ops import build as kbuild

SRC = Path(__file__).resolve().parent / "csrc" / "yolodata.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "torch_native"
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")
# Preference order: OpenMP + libjpeg (full pipeline), then degrade — a
# missing libgomp drops -fopenmp, a missing libjpeg swaps in the
# YOLO_NO_JPEG stub (decode falls back to cv2 in Python).
VARIANTS = (("openmp+libjpeg", ("-fopenmp", "-ljpeg")),
            ("libjpeg", ("-ljpeg",)),
            ("openmp", ("-fopenmp", "-DYOLO_NO_JPEG")),
            ("plain", ("-DYOLO_NO_JPEG",)))

NATIVE_BATCHES = 0
NATIVE_AUG_BATCHES = 0

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_variant: Optional[str] = None
_path: Optional[Path] = None
_jpeg_api = False


def variant_path(extra: Sequence[str]) -> Path:
    """Where the library built with ``extra`` flags lives."""
    flags = ("g++", *GXX_FLAGS, *extra)
    return BUILD_DIR / f"yolodata-{kbuild.digest(SRC, flags)}.so"


def _build(extra: Sequence[str]) -> Optional[Path]:
    so = variant_path(extra)
    if so.exists():
        return so
    try:
        proc = kbuild.compile_to(so, ["g++", *GXX_FLAGS, str(SRC), *extra],
                                 timeout=120)
    except (subprocess.SubprocessError, OSError):
        return None
    return so if proc.returncode == 0 else None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _variant, _path, _jpeg_api
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        for name, extra in VARIANTS:
            so = _build(extra)
            if so is None:
                continue
            try:
                lib = ctypes.CDLL(str(so))
            except OSError:
                continue
            _bind(lib)
            _jpeg_api = bool(lib.yolodata_has_jpeg())
            _lib, _variant, _path = lib, name, so
            break
        return _lib


def _bind(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u8pp = ctypes.POINTER(ctypes.c_char_p)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int)
    lib.resize_bilinear_batch.argtypes = [
        u8pp, i32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.resize_bilinear_batch.restype = None
    lib.encode_labels_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, ctypes.c_int, i32p, ctypes.POINTER(f32p), f32p]
    lib.encode_labels_batch.restype = None
    lib.assemble_batch.argtypes = [
        u8pp, i32p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int]
    lib.assemble_batch.restype = None
    lib.yolodata_num_threads.argtypes = []
    lib.yolodata_num_threads.restype = ctypes.c_int
    lib.yolodata_has_jpeg.argtypes = []
    lib.yolodata_has_jpeg.restype = ctypes.c_int
    lib.yolo_imread_probe.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p, i32p]
    lib.yolo_imread_probe.restype = ctypes.c_int
    lib.yolo_imread.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_long,
        i32p, i32p, i32p, i32p]
    lib.yolo_imread.restype = ctypes.c_int
    lib.yolo_imread_mem_probe.argtypes = [
        u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, i32p, i32p, i32p,
        i32p]
    lib.yolo_imread_mem_probe.restype = ctypes.c_int
    lib.yolo_imread_mem.argtypes = [
        u8p, ctypes.c_long, ctypes.c_int, ctypes.c_int, u8p, ctypes.c_long,
        i32p, i32p, i32p, i32p]
    lib.yolo_imread_mem.restype = ctypes.c_int
    lib.yolo_ingest_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, f32p, f32p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, i32p]
    lib.yolo_ingest_batch.restype = ctypes.c_int
    lib.yolo_ingest_aug_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, i32p, i32p, f32p,
        u8p, f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p, i32p]
    lib.yolo_ingest_aug_batch.restype = ctypes.c_int


def available() -> bool:
    """True if the native library is built and loadable."""
    return _load() is not None


def has_jpeg() -> bool:
    """True if the native library was built with libjpeg decode."""
    return _load() is not None and _jpeg_api


def build_variant() -> Optional[str]:
    """Name of the variant that loaded (a name of ``VARIANTS``), or None
    when no variant builds."""
    _load()
    return _variant


def library_path() -> Optional[Path]:
    """Path of the loaded library, or None."""
    _load()
    return _path


def num_threads() -> int:
    """The OpenMP team size of the library's parallel loops (1 without
    OpenMP or without the library)."""
    lib = _load()
    return lib.yolodata_num_threads() if lib is not None else 1


def imread(path: str, min_hw: Optional[Tuple[int, int]] = None
           ) -> Optional[np.ndarray]:
    """Native JPEG read -> RGB uint8 HWC array, or None (caller falls back
    to cv2 for non-JPEG formats / EXIF-rotated or corrupt files /
    no-libjpeg builds).

    min_hw: when given, the decode may use libjpeg's DCT-domain 1/2, 1/4,
    1/8 scaling as long as the result still covers (min_h, min_w).  The
    default decodes at full resolution (annotation box coordinates stay in
    source pixels).
    """
    lib = _load()
    if lib is None or not _jpeg_api:
        return None
    mh, mw = (int(min_hw[0]), int(min_hw[1])) if min_hw else (0, 0)
    # One disk read; header probe + pixel decode both run from these bytes.
    try:
        buf = np.fromfile(path, np.uint8)
    except OSError:
        return None
    if buf.size < 2 or buf[0] != 0xFF or buf[1] != 0xD8:
        return None  # not a JPEG: caller's cv2 fallback handles it
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    oh, ow, fh, fw = (ctypes.c_int() for _ in range(4))
    if lib.yolo_imread_mem_probe(bp, buf.nbytes, mh, mw, ctypes.byref(oh),
                                 ctypes.byref(ow), ctypes.byref(fh),
                                 ctypes.byref(fw)) != 0:
        return None
    out = np.empty((oh.value, ow.value, 3), np.uint8)
    rc = lib.yolo_imread_mem(
        bp, buf.nbytes, mh, mw,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.nbytes, ctypes.byref(oh), ctypes.byref(ow), ctypes.byref(fh),
        ctypes.byref(fw))
    return out if rc == 0 else None


def probe_dims(path: str) -> Optional[Tuple[int, int]]:
    """Header-only JPEG probe -> full source (h, w), or None (non-JPEG /
    EXIF-rotated / unreadable — callers fall back to a full Python load).
    The augmented-ingest planner uses it when a tile rect depends on the
    source aspect ratio (letterbox) before any pixel is decoded."""
    lib = _load()
    if lib is None or not _jpeg_api:
        return None
    oh, ow, fh, fw = (ctypes.c_int() for _ in range(4))
    rc = lib.yolo_imread_probe(path.encode(), 0, 0, ctypes.byref(oh),
                               ctypes.byref(ow), ctypes.byref(fh),
                               ctypes.byref(fw))
    return (fh.value, fw.value) if rc == 0 else None


def ingest_batch(paths: Sequence[str], boxes: np.ndarray,
                 target_hw: Tuple[int, int], dct_scale: bool = True,
                 decode_map=map) -> Tuple[np.ndarray, np.ndarray]:
    """Fully-native batch ingest: file read + JPEG decode + bilinear resize
    + /255 + box rescale, OpenMP-parallel across images — ONE GIL release
    for the whole batch.

    paths: image files; boxes: (B, max_boxes, 5) in source-image pixels
    (rescaled to target in the returned copy).  dct_scale: allow libjpeg's
    DCT-domain downscaling when the decode target is much smaller than the
    source (pixel values then differ slightly from a full decode + resize;
    False for bit-compatibility with the cv2 decode).  Non-JPEG /
    unreadable images fall back to cv2 per image, decoded through
    ``decode_map`` (``map`` by default; a thread pool's ``map`` decodes them
    in parallel, as cv2 releases the GIL; on a build without libjpeg every
    image takes this path).  Raises FileNotFoundError when an image is
    unreadable by both paths (the contract of
    ``data.pipeline.load_and_resize``).
    """
    global NATIVE_BATCHES
    dh, dw = int(target_hw[0]), int(target_hw[1])
    n = len(paths)
    out_boxes = np.ascontiguousarray(boxes, np.float32).copy()
    imgs = np.empty((n, dh, dw, 3), np.float32)
    lib = _load()
    status = np.full((n,), -100, np.int32)
    if lib is not None and _jpeg_api:
        cpaths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        lib.yolo_ingest_batch(
            cpaths, n, _f32p(imgs), _f32p(out_boxes), int(boxes.shape[1]),
            dh, dw, int(dct_scale),
            status.ctypes.data_as(ctypes.POINTER(ctypes.c_int)))
        NATIVE_BATCHES += 1
    failed = np.nonzero(status != 0)[0]
    if len(failed):
        # cv2-decode the stragglers, then resize + normalise + rescale them
        # all in ONE fused assemble_batch call: on no-libjpeg builds or
        # non-JPEG datasets every image lands here.
        import cv2

        def decode(i):
            img = cv2.imread(paths[i])
            if img is None:
                raise FileNotFoundError(paths[i])
            return np.ascontiguousarray(img[:, :, ::-1])

        rgbs = list(decode_map(decode, failed))
        f_imgs, f_boxes = assemble_batch(
            rgbs, np.ascontiguousarray(boxes, np.float32)[failed], (dh, dw))
        imgs[failed] = f_imgs
        out_boxes[failed] = f_boxes
    return imgs, out_boxes


def ingest_aug_batch(tile_paths: Sequence[str], tile_sample: np.ndarray,
                     tile_rect: np.ndarray, tile_hsv: np.ndarray,
                     flip: np.ndarray, fill: np.ndarray, batch: int,
                     target_hw: Tuple[int, int], dct_scale: bool = True
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Augmentation-capable native batch ingest (pixels only).

    The caller (DataGenerator) plans every random draw and does all box
    math; this executes the pixel work tile by tile under OpenMP: JPEG
    decode (DCT-downscaled to just cover each tile), fused bilinear resize
    + /255 + HSV jitter into the sample canvas rect, then a per-sample
    horizontal flip.  One GIL release for the whole batch.

    tile_paths: image file per tile; tile_sample: (T,) output sample index;
    tile_rect: (T, 4) int32 x0,y0,w,h canvas rects; tile_hsv: (T, 3) f32
    (hue shift in degrees, sat scale, val scale) with sat < 0 meaning no
    jitter; flip: (B,) uint8; fill: (B,) f32 canvas init value.

    Returns (imgs (B,H,W,3) f32, status (T,) int32 — <0 where a tile
    failed and the caller must redo that sample in Python, src_hw (T, 2)
    full source dims for box math).  Raises RuntimeError without the
    libjpeg build (callers gate on has_jpeg()).
    """
    global NATIVE_AUG_BATCHES
    lib = _load()
    if lib is None or not _jpeg_api:
        raise RuntimeError("native augmented ingest requires the libjpeg "
                           "build (gate on native.has_jpeg())")
    dh, dw = int(target_hw[0]), int(target_hw[1])
    n_tiles = len(tile_paths)
    tile_sample = np.ascontiguousarray(tile_sample, np.int32)
    tile_rect = np.ascontiguousarray(tile_rect, np.int32).reshape(n_tiles, 4)
    tile_hsv = np.ascontiguousarray(tile_hsv, np.float32).reshape(n_tiles, 3)
    flip = np.ascontiguousarray(flip, np.uint8)
    fill = np.ascontiguousarray(fill, np.float32)
    if not (tile_sample.shape == (n_tiles,) and flip.shape == (batch,)
            and fill.shape == (batch,)):
        raise ValueError(f"ingest_aug_batch: {n_tiles} tiles with samples "
                         f"{tile_sample.shape}, {batch} samples with flip "
                         f"{flip.shape} and fill {fill.shape}")
    imgs = np.empty((batch, dh, dw, 3), np.float32)
    status = np.full((n_tiles,), -100, np.int32)
    src_hw = np.zeros((n_tiles, 2), np.int32)
    cpaths = (ctypes.c_char_p * n_tiles)(*[p.encode() for p in tile_paths])
    i32 = ctypes.POINTER(ctypes.c_int)
    lib.yolo_ingest_aug_batch(
        cpaths, n_tiles, tile_sample.ctypes.data_as(i32),
        tile_rect.ctypes.data_as(i32), _f32p(tile_hsv),
        flip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _f32p(fill),
        _f32p(imgs), batch, dh, dw, int(dct_scale),
        status.ctypes.data_as(i32), src_hw.ctypes.data_as(i32))
    NATIVE_AUG_BATCHES += 1
    return imgs, status, src_hw


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _src_ptrs(images: Sequence[np.ndarray]):
    """Pack uint8 HWC images into (ptr array, hw array); keeps refs alive."""
    contig = [np.ascontiguousarray(im, dtype=np.uint8) for im in images]
    ptrs = (ctypes.c_char_p * len(contig))(
        *[im.ctypes.data_as(ctypes.c_char_p) for im in contig])
    hw = np.asarray([[im.shape[0], im.shape[1]] for im in contig],
                    dtype=np.int32)
    return contig, ctypes.cast(ptrs, ctypes.POINTER(ctypes.c_char_p)), hw


def resize_bilinear_batch(images: Sequence[np.ndarray],
                          target_hw: Tuple[int, int]) -> np.ndarray:
    """uint8 HWC images (any sizes) -> (B, H, W, 3) float32 in [0,1].

    cv2-compatible bilinear sampling; native when available, cv2
    otherwise.
    """
    dh, dw = target_hw
    out = np.empty((len(images), dh, dw, 3), np.float32)
    lib = _load()
    if lib is None:
        import cv2
        for i, im in enumerate(images):
            out[i] = cv2.resize(im, (dw, dh)).astype(np.float32) / 255.0
        return out
    contig, ptrs, hw = _src_ptrs(images)
    lib.resize_bilinear_batch(
        ptrs, hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _f32p(out),
        len(contig), dh, dw)
    return out


def encode_labels_batch(true_boxes: np.ndarray, input_shape: Tuple[int, int],
                        anchors: np.ndarray, num_classes: int,
                        strides: Sequence[int] = (8, 16, 32)
                        ) -> Tuple[List[np.ndarray], np.ndarray]:
    """Native GT label encoder; the contract of
    ``data.encode.preprocess_true_boxes``."""
    lib = _load()
    if lib is None:
        from .data.encode import preprocess_true_boxes
        return preprocess_true_boxes(true_boxes, input_shape, anchors,
                                     num_classes, strides)
    boxes = np.ascontiguousarray(true_boxes, np.float32)
    bs, max_boxes = boxes.shape[:2]
    h, w = int(input_shape[0]), int(input_shape[1])
    anchors = np.ascontiguousarray(anchors, np.float32)
    strides_a = np.asarray(strides, np.int32)
    grids = [np.zeros((bs, h // s, w // s, 3, 5 + num_classes), np.float32)
             for s in strides]
    xywh = np.empty((bs, max_boxes, 4), np.float32)
    grid_ptrs = (ctypes.POINTER(ctypes.c_float) * 3)(
        *[_f32p(g) for g in grids])
    lib.encode_labels_batch(
        _f32p(boxes), bs, max_boxes, h, w, _f32p(anchors), num_classes,
        strides_a.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), grid_ptrs,
        _f32p(xywh))
    return grids, xywh


def assemble_batch(images: Sequence[np.ndarray], boxes: np.ndarray,
                   target_hw: Tuple[int, int]
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Fused resize + normalise + box rescale for a batch.

    images: list of uint8 HWC arrays; boxes: (B, max_boxes, 5) absolute
    coords in each source image.  Returns ((B,H,W,3) f32, rescaled boxes).
    """
    dh, dw = target_hw
    lib = _load()
    out_boxes = np.ascontiguousarray(boxes, np.float32).copy()
    imgs = np.empty((len(images), dh, dw, 3), np.float32)
    if lib is None:
        import cv2
        for i, im in enumerate(images):
            sh, sw = im.shape[:2]
            imgs[i] = cv2.resize(im, (dw, dh)).astype(np.float32) / 255.0
            out_boxes[i, :, [0, 2]] *= dw / sw
            out_boxes[i, :, [1, 3]] *= dh / sh
        return imgs, out_boxes
    contig, ptrs, hw = _src_ptrs(images)
    lib.assemble_batch(
        ptrs, hw.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), _f32p(imgs),
        _f32p(out_boxes), len(contig), boxes.shape[1], dh, dw)
    return imgs, out_boxes
