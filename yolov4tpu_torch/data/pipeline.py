"""Host-side input pipeline: annotation lines -> numpy batches.

Counterpart of ``yolov4tpu.data.pipeline``: with the same seed and options
the batches equal the JAX package's bit for bit, on the Python path and on
the native one.  The reference's behaviours (reference utils.py:121-207):
  - cv2 read, BGR->RGB, stretch (non-letterbox) resize to the target size,
    /255 scaling, box rescale by (w/iw, h/ih);
  - per-image box shuffle and truncation to max_boxes;
  - epoch-end index shuffle.

Beyond the reference:
  - darknet's training augmentations: mosaic (``mosaic4``), cutmix
    (``cutmix2``), horizontal flip and HSV colour jitter, training-time
    letterbox and multi-scale sizes redrawn every few batches;
  - per-sample random streams seeded from ONE sequential draw of the
    generator's own stream per batch, so a batch depends on the seed alone,
    not on the worker pool's size or scheduling;
  - a lazy thread pool of per-sample workers (cv2 and the native decode
    release the GIL);
  - the native C++ ingest (``yolov4tpu_torch.native``): plain batches fully
    in C++, augmented ones planned here and their pixels made in C++;
  - a background prefetch thread that overlaps host ingest with the step.

``PYTHON_BATCHES`` counts the batches the Python path produced and
``PYTHON_REDO_SAMPLES`` the samples of a native augmented batch that were
redone in Python (non-JPEG or EXIF-rotated files); ``native.NATIVE_BATCHES``
and ``native.NATIVE_AUG_BATCHES`` count the native ones.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, YoloConfig
from ..utils.profiling import span
from .encode import preprocess_true_boxes

PYTHON_BATCHES = 0
PYTHON_REDO_SAMPLES = 0


def letterbox_transform(raw_hw, target_hw):
    """(scale, dx, dy): raw -> model coords are x*scale+dx, y*scale+dy."""
    ih, iw = raw_hw
    h, w = target_hw
    s = min(w / iw, h / ih)
    nw, nh = int(round(iw * s)), int(round(ih * s))
    return s, (w - nw) // 2, (h - nh) // 2


def letterbox_resize(img: np.ndarray, target_hw, boxes: np.ndarray):
    """Aspect-preserving resize onto a gray canvas + box remap.

    img: HWC uint8/float RGB; boxes: (M, 5) corner px + class.
    Returns (float32 HWC in [0,1], remapped boxes, (scale, dx, dy)).
    """
    import cv2

    ih, iw = img.shape[:2]
    h, w = target_hw
    s, dx, dy = letterbox_transform((ih, iw), (h, w))
    nw, nh = int(round(iw * s)), int(round(ih * s))
    canvas = np.full((h, w, 3), 0.5, np.float32)
    canvas[dy:dy + nh, dx:dx + nw] = (
        cv2.resize(np.ascontiguousarray(img), (nw, nh)).astype(np.float32)
        / 255.0)
    if len(boxes):
        boxes = boxes.astype(np.float32).copy()
        boxes[:, [0, 2]] = boxes[:, [0, 2]] * s + dx
        boxes[:, [1, 3]] = boxes[:, [1, 3]] * s + dy
    return canvas, boxes, (s, dx, dy)


def letterbox_unmap(boxes_norm: np.ndarray, transform, model_hw, raw_hw):
    """Normalised model-space corner boxes -> raw-image pixel coordinates.

    transform: the (scale, dx, dy) from letterbox_transform/letterbox_resize.
    The one inverse mapping, used by inference postprocess and the mAP
    export alike.
    """
    s, dx, dy = transform
    mh, mw = model_hw
    rh, rw = raw_hw
    out = np.asarray(boxes_norm, np.float32).copy()
    out[..., [0, 2]] = np.clip((out[..., [0, 2]] * mw - dx) / s, 0, rw)
    out[..., [1, 3]] = np.clip((out[..., [1, 3]] * mh - dy) / s, 0, rh)
    return out


def read_image_rgb(img_path: str, native_decode: bool = True) -> np.ndarray:
    """Image file -> RGB uint8 HWC.

    Decodes JPEGs through the native libjpeg path when available (releases
    the GIL for the whole decode — the dominant host cost — so threaded
    workers scale with cores; bit-identical to cv2's decode for plain
    JPEGs, both are libjpeg-turbo).  EXIF-rotated JPEGs (orientation tag
    != 1, which cv2.imread auto-applies) are detected in the native probe
    and routed here to cv2 so image/box geometry stays consistent.
    Everything else (PNG, no toolchain) also falls back to cv2.imread +
    BGR->RGB (reference utils.py:192-194).
    """
    if native_decode:
        from .. import native

        img = native.imread(img_path) if native.has_jpeg() else None
        if img is not None:
            return img
    import cv2

    img = cv2.imread(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    return img[:, :, ::-1]


def load_and_resize(img_path: str, target_hw, boxes: np.ndarray,
                    letterbox: bool = False, color_jitter_rng=None,
                    native_decode: bool = True):
    """Read (BGR->RGB) + resize + box rescale (reference utils.py:187-204).

    Default is the reference's stretch (non-letterbox) resize; with
    ``letterbox=True`` the aspect ratio is preserved with gray padding.
    color_jitter_rng: when set, HSV jitter is applied to the RAW image
    before any resize/padding — so letterbox bars stay exactly gray (the
    constant inference uses) and mosaic tiles jitter independently, like
    darknet.
    """
    import cv2

    img = read_image_rgb(img_path, native_decode=native_decode)
    if color_jitter_rng is not None:
        img = (random_color_jitter(
            img.astype(np.float32) / 255.0, color_jitter_rng) * 255.0)
    if letterbox:
        img, boxes, _ = letterbox_resize(img, target_hw, boxes)
        return img, boxes
    ih, iw = img.shape[:2]
    h, w = target_hw
    img = cv2.resize(img, (w, h)).astype(np.float32) / 255.0
    if len(boxes):
        boxes = boxes.astype(np.float32).copy()
        boxes[:, [0, 2]] *= w / iw
        boxes[:, [1, 3]] *= h / ih
    return img, boxes


def random_hflip(img: np.ndarray, boxes: np.ndarray,
                 rng: np.random.Generator, prob: float = 0.5):
    """Horizontal flip with box remap (darknet-style train-time aug; the
    reference had no geometric augmentation at all, reference
    utils.py:187-207)."""
    if rng.uniform() >= prob:
        return img, boxes
    w = img.shape[1]
    img = img[:, ::-1].copy()
    if len(boxes):
        boxes = boxes.astype(np.float32).copy()
        x1 = boxes[:, 0].copy()
        boxes[:, 0] = w - boxes[:, 2]
        boxes[:, 2] = w - x1
    return img, boxes


def random_color_jitter(img: np.ndarray, rng: np.random.Generator,
                        hue: float = 0.1, sat: float = 0.5, val: float = 0.5):
    """HSV jitter on a float RGB [0,1] image (darknet's hue/sat/exposure).

    Factors are drawn like darknet: sat/val scale in [1/(1+s), 1+s], hue
    shift uniform in [-h, h] turns.
    """
    import cv2

    h = rng.uniform(-hue, hue)
    def scale(s):
        f = 1 + rng.uniform(0, s)
        return f if rng.uniform() < 0.5 else 1.0 / f
    fs, fv = scale(sat), scale(val)
    # Float-path cvtColor: H in [0,360), S/V in [0,1].  Keeps darknet's
    # full-precision jitter — a uint8 round trip would quantize hue to
    # 2-degree bins and sat/val to 8 bits.
    hsv = cv2.cvtColor(np.ascontiguousarray(img, np.float32),
                       cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
    hsv[..., 1] = np.clip(hsv[..., 1] * fs, 0.0, 1.0)
    hsv[..., 2] = np.clip(hsv[..., 2] * fv, 0.0, 1.0)
    out = cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)
    return np.clip(out, 0.0, 1.0)


def mosaic4(samples, target_hw, rng: np.random.Generator):
    """Mosaic augmentation: 4 (img, boxes) -> one mosaic (img, boxes).

    Implements the reference's unchecked 'Mosaic data augmentation' TODO
    (reference README.md:11).  Each source image is stretch-resized into one
    quadrant around a random center; boxes follow affinely and are clipped.
    """
    import cv2

    h, w = target_hw
    cy = int(rng.uniform(0.3, 0.7) * h)
    cx = int(rng.uniform(0.3, 0.7) * w)
    canvas = np.zeros((h, w, 3), np.float32)
    out_boxes = []
    quads = [(0, 0, cx, cy), (cx, 0, w - cx, cy),
             (0, cy, cx, h - cy), (cx, cy, w - cx, h - cy)]
    for (img, boxes), (x0, y0, qw, qh) in zip(samples, quads):
        if qw < 2 or qh < 2:
            continue
        sh, sw = img.shape[:2]
        canvas[y0:y0 + qh, x0:x0 + qw] = cv2.resize(img, (qw, qh))
        if len(boxes):
            b = boxes.astype(np.float32).copy()
            b[:, [0, 2]] = b[:, [0, 2]] * (qw / sw) + x0
            b[:, [1, 3]] = b[:, [1, 3]] * (qh / sh) + y0
            b[:, [0, 2]] = np.clip(b[:, [0, 2]], x0, x0 + qw)
            b[:, [1, 3]] = np.clip(b[:, [1, 3]], y0, y0 + qh)
            keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
            out_boxes.append(b[keep])
    boxes = (np.concatenate(out_boxes, axis=0) if out_boxes
             else np.zeros((0, 5), np.float32))
    return canvas, boxes


def cutmix2(sample_a, sample_b, rng: np.random.Generator):
    """CutMix for detection: paste a random rectangle of image B into A.

    Implements the reference's unchecked 'Cutmix' TODO (reference
    README.md:10-13).  Boxes from B inside the pasted region are clipped to
    it; boxes from A mostly covered by the region (>80% of their area) are
    dropped, others kept unchanged.
    """
    (img_a, boxes_a), (img_b, boxes_b) = sample_a, sample_b
    h, w = img_a.shape[:2]
    rw = int(rng.uniform(0.2, 0.5) * w)
    rh = int(rng.uniform(0.2, 0.5) * h)
    x0 = int(rng.uniform(0, w - rw))
    y0 = int(rng.uniform(0, h - rh))
    x1, y1 = x0 + rw, y0 + rh

    import cv2

    out = img_a.copy()
    bh, bw = img_b.shape[:2]
    out[y0:y1, x0:x1] = cv2.resize(img_b, (rw, rh)) if (bh, bw) != (h, w) \
        else img_b[y0:y1, x0:x1]

    kept = []
    if len(boxes_a):
        a = boxes_a.astype(np.float32)
        ix = np.maximum(np.minimum(a[:, 2], x1) - np.maximum(a[:, 0], x0), 0)
        iy = np.maximum(np.minimum(a[:, 3], y1) - np.maximum(a[:, 1], y0), 0)
        inter = ix * iy
        area = np.maximum((a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1]), 1e-6)
        kept.append(a[inter / area <= 0.8])
    if len(boxes_b):
        b = boxes_b.astype(np.float32).copy()
        if (bh, bw) != (h, w):
            b[:, [0, 2]] *= rw / bw
            b[:, [1, 3]] *= rh / bh
            b[:, [0, 2]] += x0
            b[:, [1, 3]] += y0
        b[:, [0, 2]] = np.clip(b[:, [0, 2]], x0, x1)
        b[:, [1, 3]] = np.clip(b[:, [1, 3]], y0, y1)
        keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
        kept.append(b[keep])
    boxes = (np.concatenate(kept, axis=0) if kept
             else np.zeros((0, 5), np.float32))
    return out, boxes


class DataGenerator:
    """Batched data generator (reference utils.py:121-207 equivalent).

    Yields dict batches {'image': (B,H,W,3), 'labels': [3 grids],
    'boxes': (B,max_boxes,4)} of numpy arrays — or {'image', 'raw_boxes'}
    with ``config.encode_on_device``; ``__getitem__`` also offers the
    reference's tuple format.  ``use_native=True`` (the default, as in the
    JAX package) takes the native ingest when its library builds
    (``self.use_native`` says whether it did); ``close()`` or a ``with``
    block shuts the worker pool down.
    """

    def __init__(self, annotation_lines: Sequence[str], class_name_path: str,
                 folder_path: str, max_boxes: int = 100, shuffle: bool = True,
                 config: YoloConfig = DEFAULT_CONFIG, mosaic: bool = False,
                 cutmix: bool = False, seed: Optional[int] = None,
                 use_native: bool = True):
        self.annotation_lines = list(annotation_lines)
        with open(class_name_path) as f:
            self.num_classes = len([line.strip() for line in f])
        self.config = config
        self.batch_size = config.batch_size * config.num_devices
        self.target_img_size = config.img_size
        self._ms_counter = 0
        if config.multi_scale is not None:
            lo, hi = config.multi_scale
            if not (lo % 32 == 0 and hi % 32 == 0 and lo <= hi):
                raise ValueError(
                    f"multi_scale bounds {config.multi_scale} must be "
                    "multiples of 32 with lo <= hi (stride contract, "
                    "reference models.py:23-24)")
        self.anchors = config.anchors_flat
        self.shuffle = shuffle
        self.folder_path = folder_path
        self.max_boxes = max_boxes
        self.mosaic = mosaic or config.use_mosaic
        self.cutmix = cutmix or config.use_cutmix
        self.rng = np.random.default_rng(seed)
        self.indexes = np.arange(len(self.annotation_lines))
        if use_native:
            from .. import native
            self.use_native = native.available()
        else:
            self.use_native = False
        # Parallel per-sample workers: cv2 and the native libjpeg decode
        # release the GIL, so a thread pool scales the decode+augment work
        # with host cores.  Determinism: each sample gets its own Generator
        # seeded from ONE sequential draw of self.rng, so batch content is
        # a function of the generator seed alone — not of worker count or
        # thread scheduling.
        self._workers = (config.num_workers if config.num_workers is not None
                         else (os.cpu_count() or 1))
        # Pool is created lazily on first parallel batch and shut down by
        # close() / context exit / garbage collection (weakref.finalize) —
        # generators are cheap to construct and must not each pin
        # cpu_count threads for the process lifetime.
        self._pool = None
        self._pool_finalizer = None
        # path -> (h, w) header-probe cache for the native letterbox
        # planner (None entries mark files the native decoder can't take).
        self._dims_cache: dict = {}
        self.on_epoch_end()

    def _get_pool(self):
        if self._pool is None and self._workers > 1:
            import concurrent.futures
            import weakref
            self._pool = concurrent.futures.ThreadPoolExecutor(
                max_workers=self._workers, thread_name_prefix="yolodata")
            self._pool_finalizer = weakref.finalize(
                self, self._pool.shutdown, wait=False)
        return self._pool

    def close(self):
        """Shut down the worker pool (idempotent).  Also runs on GC and
        via context-manager exit."""
        if self._pool_finalizer is not None:
            self._pool_finalizer()
            self._pool_finalizer = None
        self._pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self) -> int:
        return int(np.ceil(len(self.annotation_lines) / self.batch_size))

    def on_epoch_end(self):
        if self.shuffle:
            self.rng.shuffle(self.indexes)

    # -- single-sample load ------------------------------------------------
    def _parse_line(self, line: str):
        parts = line.split()
        img_path = os.path.join(self.folder_path, parts[0])
        boxes = np.array([[float(v) for v in b.split(",")] for b in parts[1:]],
                         dtype=np.float32).reshape(-1, 5)
        return img_path, boxes

    def _load_line(self, line: str, rng=None):
        img_path, boxes = self._parse_line(line)
        rng = self.rng if rng is None else rng
        return load_and_resize(
            img_path, self.target_img_size[:2], boxes,
            letterbox=self.config.letterbox,
            color_jitter_rng=(rng if self.config.use_color_jitter else None),
            native_decode=self.use_native)

    def get_data(self, annotation_line: str, rng=None):
        """(img float32 HWC /255, box_data (max_boxes,5)) for one line.

        rng: per-sample Generator (parallel workers each get their own,
        seeded from one sequential draw of self.rng — see get_batch);
        defaults to the generator's own stream for single-sample use.
        """
        rng = self.rng if rng is None else rng
        img, boxes = self._load_line(annotation_line, rng)
        if self.mosaic:
            extra = [self._load_line(self.annotation_lines[i], rng) for i in
                     rng.integers(0, len(self.annotation_lines), 3)]
            img, boxes = mosaic4([(img, boxes)] + extra,
                                 self.target_img_size[:2], rng)
        if self.cutmix:
            other = self._load_line(self.annotation_lines[
                int(rng.integers(0, len(self.annotation_lines)))], rng)
            img, boxes = cutmix2((img, boxes), other, rng)
        # Color jitter already ran per-sample on the RAW images inside
        # _load_line (before resize/padding/mosaic); only the geometric flip
        # applies to the composite here.
        if self.config.use_hflip:
            img, boxes = random_hflip(img, boxes, rng)
        box_data = np.zeros((self.max_boxes, 5), np.float32)
        if len(boxes):
            perm = rng.permutation(len(boxes))
            boxes = boxes[perm][:self.max_boxes]
            box_data[:len(boxes)] = boxes
        return img, box_data

    # -- batching ----------------------------------------------------------

    def _image_wire(self, X: np.ndarray) -> np.ndarray:
        """Wire format for the image batch: float32 [0,1] by default, or
        uint8 when config.transfer_uint8 (the train step normalises on the
        card — 4x less host-to-device traffic).  For plain resized samples
        the round trip is exact (the f32 values ARE u8/255); color-jittered or
        native-resized samples re-quantize with <=1/510 error."""
        if not self.config.transfer_uint8:
            return X
        return np.clip(np.rint(X * 255.0), 0, 255).astype(np.uint8)

    def _get_batch_native(self, lines: Sequence[str],
                          seeds: np.ndarray) -> dict:
        """Fully-native fused path: file read + JPEG decode (+ DCT-domain
        downscale) + resize + /255 + box rescale + label encode all in C++
        — ONE GIL release for the whole batch, OpenMP across images."""
        from .. import native

        n = len(lines)
        paths, y_bbox = [], np.zeros((n, self.max_boxes, 5), np.float32)
        for i, line in enumerate(lines):
            img_path, boxes = self._parse_line(line)
            paths.append(img_path)
            if len(boxes):
                perm = np.random.default_rng(seeds[i]).permutation(len(boxes))
                boxes = boxes[perm][:self.max_boxes]
                y_bbox[i, :len(boxes)] = boxes
        # Images the library cannot decode (not JPEG, EXIF-rotated, or all
        # of them on a build without libjpeg) are decoded by cv2 in the
        # worker pool: the same bytes as one after another.
        pool = self._get_pool() if n > 1 else None
        X, y_bbox = native.ingest_batch(
            paths, y_bbox, self.target_img_size[:2],
            dct_scale=self.config.fast_decode,
            decode_map=map if pool is None else pool.map)
        X = self._image_wire(X)
        if self.config.encode_on_device:
            return {"image": X, "raw_boxes": y_bbox}
        y_tensor, y_true_boxes_xywh = native.encode_labels_batch(
            y_bbox, self.target_img_size[:2], self.anchors, self.num_classes,
            self.config.strides)
        return {"image": X, "labels": y_tensor, "boxes": y_true_boxes_xywh}

    # -- native augmented ingest (plan in python, pixels in C++) ------------
    #
    # Each sample splits into a PLAN and its PIXELS: every random draw
    # happens here, sequentially, from the per-sample seeded rng in EXACTLY
    # get_data's draw order (so batches stay a function of the seed alone
    # and box geometry is bit-identical to the python path), while the
    # per-pixel work (JPEG decode DCT-downscaled to each tile rect, fused
    # resize + /255 + HSV jitter, mosaic compositing, hflip) runs in
    # csrc/yolodata.cpp::yolo_ingest_aug_batch under OpenMP with one GIL
    # release per batch.  Pixel content differs benignly from the python
    # path (single source->rect resize instead of the python double
    # resize; jitter after the resize instead of before), the box geometry
    # does not.  The slow host loop this replaces is reference
    # utils.py:187-207.

    def _plan_sample(self, line: str, rng) -> dict:
        """All random draws for one sample, in get_data's exact order."""
        jitter_on = self.config.use_color_jitter

        def draw_jitter():
            # Mirrors random_color_jitter(hue=0.1, sat=0.5, val=0.5) —
            # the defaults _load_line uses — draw for draw.
            if not jitter_on:
                return None
            h = rng.uniform(-0.1, 0.1)

            def scale(s):
                f = 1 + rng.uniform(0, s)
                return f if rng.uniform() < 0.5 else 1.0 / f

            return (h * 360.0, scale(0.5), scale(0.5))

        path, boxes = self._parse_line(line)
        tiles = [(path, boxes, draw_jitter())]
        center = None
        if self.mosaic:
            idxs = rng.integers(0, len(self.annotation_lines), 3)
            for i in idxs:
                p, b = self._parse_line(self.annotation_lines[int(i)])
                tiles.append((p, b, draw_jitter()))
            h, w = self.target_img_size[:2]
            center = (int(rng.uniform(0.3, 0.7) * h),
                      int(rng.uniform(0.3, 0.7) * w))
        flip = bool(self.config.use_hflip and rng.uniform() < 0.5)
        return {"tiles": tiles, "center": center, "flip": flip, "rng": rng}

    def _get_batch_native_aug(self, lines: Sequence[str],
                              seeds: np.ndarray) -> dict:
        from .. import native

        h, w = self.target_img_size[:2]
        n = len(lines)
        plans = [self._plan_sample(line, np.random.default_rng(s))
                 for line, s in zip(lines, seeds)]

        tile_paths: List[str] = []
        tile_sample: List[int] = []
        tile_rect: List[tuple] = []
        tile_hsv: List[tuple] = []
        fill = np.zeros((n,), np.float32)
        flip = np.zeros((n,), np.uint8)
        fallback = np.zeros((n,), bool)
        # Per sample: list of (tile, rect) actually emitted — mosaic skips
        # degenerate <2px quads exactly like python mosaic4 does.
        emitted: List[list] = []
        for i, plan in enumerate(plans):
            flip[i] = plan["flip"]
            em = []
            if plan["center"] is not None:
                cy, cx = plan["center"]
                quads = [(0, 0, cx, cy), (cx, 0, w - cx, cy),
                         (0, cy, cx, h - cy), (cx, cy, w - cx, h - cy)]
                for tile, rect in zip(plan["tiles"], quads):
                    if rect[2] < 2 or rect[3] < 2:
                        continue
                    em.append((tile, rect, None))
            elif self.config.letterbox:
                # Rect needs the source aspect ratio before decode: a
                # header-only probe (cached across epochs).  Non-JPEG or
                # EXIF-rotated files redo the whole sample in python.
                tile = plan["tiles"][0]
                dims = self._dims_cache.get(tile[0])
                if dims is None:
                    dims = native.probe_dims(tile[0])
                    self._dims_cache[tile[0]] = dims
                if dims is None:
                    fallback[i] = True
                    emitted.append([])
                    continue
                s, dx, dy = letterbox_transform(dims, (h, w))
                nw = int(round(dims[1] * s))
                nh = int(round(dims[0] * s))
                fill[i] = 0.5
                em.append((tile, (dx, dy, nw, nh), (s, dx, dy)))
            else:
                em.append((plan["tiles"][0], (0, 0, w, h), None))
            for tile, rect, _ in em:
                tile_paths.append(tile[0])
                tile_sample.append(i)
                tile_rect.append(rect)
                tile_hsv.append(tile[2] if tile[2] is not None
                                else (0.0, -1.0, 1.0))
            emitted.append(em)

        X = np.zeros((n, h, w, 3), np.float32)
        status = np.empty((0,), np.int32)
        src_hw = np.empty((0, 2), np.int32)
        if tile_paths:
            X, status, src_hw = native.ingest_aug_batch(
                tile_paths, np.asarray(tile_sample), np.asarray(tile_rect),
                np.asarray(tile_hsv, np.float32), flip, fill, n, (h, w),
                dct_scale=self.config.fast_decode)

        global PYTHON_REDO_SAMPLES
        y_bbox = np.zeros((n, self.max_boxes, 5), np.float32)
        t = 0
        for i, (plan, em) in enumerate(zip(plans, emitted)):
            k = len(em)
            st, hw = status[t:t + k], src_hw[t:t + k]
            t += k
            if fallback[i] or (st != 0).any():
                # Redo the SAMPLE in python from the same seed — identical
                # draws by construction, so determinism survives mixed
                # native/python batches (non-JPEG files, EXIF rotation).
                X[i], y_bbox[i] = self.get_data(
                    lines[i], np.random.default_rng(seeds[i]))
                PYTHON_REDO_SAMPLES += 1
                continue
            boxes = self._plan_boxes(plan, em, hw, (h, w))
            if len(boxes):
                perm = plan["rng"].permutation(len(boxes))
                boxes = boxes[perm][:self.max_boxes]
                y_bbox[i, :len(boxes)] = boxes

        X = self._image_wire(X)
        if self.config.encode_on_device:
            return {"image": X, "raw_boxes": y_bbox}
        y_tensor, y_true_boxes_xywh = native.encode_labels_batch(
            y_bbox, self.target_img_size[:2], self.anchors, self.num_classes,
            self.config.strides)
        return {"image": X, "labels": y_tensor, "boxes": y_true_boxes_xywh}

    def _plan_boxes(self, plan: dict, emitted: list, src_hw: np.ndarray,
                    target_hw) -> np.ndarray:
        """Box geometry for one planned sample — the same float expressions,
        in the same order, as the python path (load_and_resize ->
        mosaic4/letterbox_resize -> random_hflip), so results are
        bit-identical to get_data's."""
        h, w = target_hw
        out = []
        for (tile, rect, lb), (ih, iw) in zip(emitted, src_hw):
            # Python ints, NOT np.int32: `w / np.int32` is a STRONG f64
            # scalar under NEP 50 and would promote the `*=` below to f64
            # math, off-by-an-ulp from the python path's weak-float f32
            # computation (img.shape gives python ints there).
            ih, iw = int(ih), int(iw)
            boxes = tile[1]
            if plan["center"] is not None:
                x0, y0, qw, qh = rect
                if not len(boxes):
                    continue
                # load_and_resize stretch math...
                b = boxes.astype(np.float32).copy()
                b[:, [0, 2]] *= w / iw
                b[:, [1, 3]] *= h / ih
                # ...then mosaic4's quadrant affine with sw=w, sh=h.
                b[:, [0, 2]] = b[:, [0, 2]] * (qw / w) + x0
                b[:, [1, 3]] = b[:, [1, 3]] * (qh / h) + y0
                b[:, [0, 2]] = np.clip(b[:, [0, 2]], x0, x0 + qw)
                b[:, [1, 3]] = np.clip(b[:, [1, 3]], y0, y0 + qh)
                keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
                if keep.any():
                    out.append(b[keep])
            elif lb is not None:  # letterbox_resize box math
                if not len(boxes):
                    continue
                s, dx, dy = lb
                b = boxes.astype(np.float32).copy()
                b[:, [0, 2]] = b[:, [0, 2]] * s + dx
                b[:, [1, 3]] = b[:, [1, 3]] * s + dy
                out.append(b)
            else:  # plain stretch
                if not len(boxes):
                    continue
                b = boxes.astype(np.float32).copy()
                b[:, [0, 2]] *= w / iw
                b[:, [1, 3]] *= h / ih
                out.append(b)
        boxes = (np.concatenate(out, axis=0) if out
                 else np.zeros((0, 5), np.float32))
        if plan["flip"] and len(boxes):  # random_hflip's remap
            boxes = boxes.astype(np.float32).copy()
            x1 = boxes[:, 0].copy()
            boxes[:, 0] = w - boxes[:, 2]
            boxes[:, 2] = w - x1
        return boxes

    def get_batch(self, index: int) -> dict:
        global PYTHON_BATCHES
        if self.config.multi_scale is not None:
            # Darknet-style multi-scale: re-draw a square size every
            # interval batches; everything downstream (resize, letterbox,
            # mosaic, native encode, label grids) keys off target_img_size.
            interval = max(1, self.config.multi_scale_interval)
            if self._ms_counter % interval == 0:
                lo, hi = self.config.multi_scale
                sizes = np.arange(lo, hi + 1, 32)
                s = int(sizes[self.rng.integers(0, len(sizes))])
                self.target_img_size = (s, s, self.config.img_size[2])
            self._ms_counter += 1
        b = self.batch_size
        idxs = self.indexes[index * b:(index + 1) * b]
        lines = [self.annotation_lines[i] for i in idxs]
        n = len(lines)
        # ONE sequential draw of per-sample seeds keeps results independent
        # of worker count/scheduling AND identical between the fused-native
        # and python paths (both derive each sample's stream the same way).
        seeds = self.rng.integers(0, 2 ** 63, size=n, dtype=np.uint64)
        if self.use_native and not self.cutmix:
            any_aug = (self.mosaic or self.config.letterbox
                       or self.config.use_hflip
                       or self.config.use_color_jitter)
            if not any_aug:
                return self._get_batch_native(lines, seeds)
            # Augmented/letterbox batches: plan in python, pixels in C++.
            # Letterbox-of-mosaic-tiles isn't expressible as one
            # source->rect resize; that combination stays in python.
            from .. import native
            if native.has_jpeg() and not (
                    self.mosaic and self.config.letterbox):
                return self._get_batch_native_aug(lines, seeds)
        X = np.empty((n, *self.target_img_size), np.float32)
        y_bbox = np.empty((n, self.max_boxes, 5), np.float32)
        pool = self._get_pool() if n > 1 else None
        if pool is not None:
            # Per-sample parallelism: decode (native libjpeg when
            # available), resize, jitter, mosaic, cutmix and flip all run
            # inside the workers.
            results = pool.map(
                lambda args: self.get_data(args[0],
                                           np.random.default_rng(args[1])),
                zip(lines, seeds))
            for i, (img, bd) in enumerate(results):
                X[i], y_bbox[i] = img, bd
        else:
            for i, line in enumerate(lines):
                X[i], y_bbox[i] = self.get_data(
                    line, np.random.default_rng(seeds[i]))
        PYTHON_BATCHES += 1
        X = self._image_wire(X)
        if self.config.encode_on_device:
            # Raw boxes; the train step encodes the grids on the device
            # (data.encode.encode_labels_torch).
            return {"image": X, "raw_boxes": y_bbox}
        y_tensor, y_true_boxes_xywh = preprocess_true_boxes(
            y_bbox, self.target_img_size[:2], self.anchors, self.num_classes,
            self.config.strides)
        return {"image": X, "labels": y_tensor, "boxes": y_true_boxes_xywh}

    def __getitem__(self, index: int):
        """Reference-shaped output: ([X, *label_grids, boxes], zeros)
        (reference utils.py:149-161)."""
        b = self.get_batch(index)
        if "labels" not in b:
            # encode_on_device ships raw boxes; the reference tuple contract
            # still owes host-encoded grids, so encode here.
            labels, xywh = preprocess_true_boxes(
                b["raw_boxes"], self.target_img_size[:2], self.anchors,
                self.num_classes, self.config.strides)
            b = {"image": b["image"], "labels": labels, "boxes": xywh}
        return ([b["image"], *b["labels"], b["boxes"]],
                np.zeros(len(b["image"])))

    def __iter__(self) -> Iterator[dict]:
        for i in range(len(self)):
            yield self.get_batch(i)
        self.on_epoch_end()


def prefetch(generator: DataGenerator, n_prefetch: int = 2,
             epochs: Optional[int] = None,
             transform=None) -> Iterator[dict]:
    """Background-thread prefetching over epochs of a DataGenerator.

    transform: optional fn applied to each batch in the producer thread —
    the trainer passes one that copies the batch to the card from pinned
    memory without blocking, so batch N+1's copy overlaps batch N's step.
    A failure in the producer is raised again in the consumer.
    """
    q: "queue.Queue" = queue.Queue(maxsize=n_prefetch)
    stop = threading.Event()
    failure: list = []

    def producer():
        epoch, n = 0, 0     # n: the batch's number, its spans' id
        try:
            while not stop.is_set() and (epochs is None or epoch < epochs):
                for i in range(len(generator)):
                    if stop.is_set():
                        return
                    with span("ingest.batch", id=n) as record:
                        b = generator.get_batch(i)
                        if record:
                            record.count(images=len(b["image"]))
                    if transform is not None:
                        with span("ingest.place", id=n):
                            b = transform(b)
                    q.put(b)
                    n += 1
                generator.on_epoch_end()
                epoch += 1
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            failure.append(e)
        finally:
            q.put(None)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                if failure:
                    raise failure[0]
                break
            yield item
    finally:
        stop.set()
        # Drain so the producer can observe the stop flag.
        while not q.empty():
            q.get_nowait()
