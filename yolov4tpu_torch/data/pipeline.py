"""Host-side input pipeline: annotation lines -> numpy batches.

Counterpart of ``yolov4tpu.data.pipeline`` on its python path
(``DataGenerator(use_native=False)``), with the reference's behaviours
(reference utils.py:121-207):
  - cv2 read, BGR->RGB, stretch (non-letterbox) resize to the target size,
    /255 scaling, box rescale by (w/iw, h/ih);
  - per-image box shuffle and truncation to max_boxes;
  - epoch-end index shuffle;
  - per-sample random streams seeded from ONE sequential draw of the
    generator's own stream per batch, so with the same seed the batches equal
    the JAX package's bit for bit;
  - a background prefetch thread that overlaps host decode with the step.

The letterbox geometry (``letterbox_transform``, ``letterbox_resize``,
``letterbox_unmap``) serves inference and the mAP export.  Not ported yet
in ``DataGenerator`` (each raises ``NotImplementedError`` naming ROADMAP.md
queue A item 15): mosaic, cutmix, horizontal flip, colour jitter,
training-time letterbox, multi-scale and the native C++ ingest.  Samples
load one after another in the calling thread (the JAX package's thread pool
gives the same batches).
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..config import DEFAULT_CONFIG, YoloConfig
from .encode import preprocess_true_boxes

_NOT_PORTED = "is not ported yet (ROADMAP.md queue A item 15)"


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


def read_image_rgb(img_path: str) -> np.ndarray:
    """Image file -> RGB uint8 HWC through cv2 (reference utils.py:192-194)."""
    import cv2

    img = cv2.imread(img_path)
    if img is None:
        raise FileNotFoundError(img_path)
    return img[:, :, ::-1]


def load_and_resize(img_path: str, target_hw, boxes: np.ndarray):
    """Read (BGR->RGB) + stretch resize + box rescale (reference
    utils.py:187-204).  Returns (float32 HWC in [0, 1], boxes)."""
    import cv2

    img = read_image_rgb(img_path)
    ih, iw = img.shape[:2]
    h, w = target_hw
    img = cv2.resize(img, (w, h)).astype(np.float32) / 255.0
    if len(boxes):
        boxes = boxes.astype(np.float32).copy()
        boxes[:, [0, 2]] *= w / iw
        boxes[:, [1, 3]] *= h / ih
    return img, boxes


class DataGenerator:
    """Batched data generator (reference utils.py:121-207 equivalent).

    Yields dict batches {'image': (B,H,W,3), 'labels': [3 grids],
    'boxes': (B,max_boxes,4)} of numpy arrays — or {'image', 'raw_boxes'}
    with ``config.encode_on_device``; ``__getitem__`` also offers the
    reference's tuple format.
    """

    def __init__(self, annotation_lines: Sequence[str], class_name_path: str,
                 folder_path: str, max_boxes: int = 100, shuffle: bool = True,
                 config: YoloConfig = DEFAULT_CONFIG, mosaic: bool = False,
                 cutmix: bool = False, seed: Optional[int] = None,
                 use_native: bool = False):
        unported = {"mosaic": mosaic or config.use_mosaic,
                    "cutmix": cutmix or config.use_cutmix,
                    "hflip": config.use_hflip,
                    "colour jitter": config.use_color_jitter,
                    "training-time letterbox": config.letterbox,
                    "multi-scale": config.multi_scale is not None,
                    "the native C++ ingest (use_native=True)": use_native}
        for name, on in unported.items():
            if on:
                raise NotImplementedError(f"DataGenerator: {name} "
                                          f"{_NOT_PORTED}")
        self.annotation_lines = list(annotation_lines)
        with open(class_name_path) as f:
            self.num_classes = len([line.strip() for line in f])
        self.config = config
        self.batch_size = config.batch_size * config.num_devices
        self.target_img_size = config.img_size
        self.anchors = config.anchors_flat
        self.shuffle = shuffle
        self.folder_path = folder_path
        self.max_boxes = max_boxes
        self.rng = np.random.default_rng(seed)
        self.indexes = np.arange(len(self.annotation_lines))
        self.on_epoch_end()

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

    def _load_line(self, line: str):
        img_path, boxes = self._parse_line(line)
        return load_and_resize(img_path, self.target_img_size[:2], boxes)

    def get_data(self, annotation_line: str, rng=None):
        """(img float32 HWC /255, box_data (max_boxes, 5)) for one line.
        rng: the sample's own Generator (see get_batch); defaults to the
        generator's stream."""
        rng = self.rng if rng is None else rng
        img, boxes = self._load_line(annotation_line)
        box_data = np.zeros((self.max_boxes, 5), np.float32)
        if len(boxes):
            perm = rng.permutation(len(boxes))
            boxes = boxes[perm][:self.max_boxes]
            box_data[:len(boxes)] = boxes
        return img, box_data

    # -- batching ----------------------------------------------------------
    def _image_wire(self, X: np.ndarray) -> np.ndarray:
        """float32 [0, 1] by default, or uint8 with config.transfer_uint8
        (the train step divides by 255 on the device: 4x less host-to-device
        traffic; exact for plain resized samples)."""
        if not self.config.transfer_uint8:
            return X
        return np.clip(np.rint(X * 255.0), 0, 255).astype(np.uint8)

    def get_batch(self, index: int) -> dict:
        idxs = self.indexes[index * self.batch_size:(index + 1) * self.batch_size]
        lines = [self.annotation_lines[i] for i in idxs]
        n = len(lines)
        # ONE sequential draw of per-sample seeds, as the JAX package draws
        # them: batch content depends on the generator seed alone.
        seeds = self.rng.integers(0, 2 ** 63, size=n, dtype=np.uint64)
        X = np.empty((n, *self.target_img_size), np.float32)
        y_bbox = np.empty((n, self.max_boxes, 5), np.float32)
        for i, line in enumerate(lines):
            X[i], y_bbox[i] = self.get_data(line,
                                            np.random.default_rng(seeds[i]))
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
            labels, xywh = preprocess_true_boxes(
                b["raw_boxes"], self.target_img_size[:2], self.anchors,
                self.num_classes, self.config.strides)
            b = {"image": b["image"], "labels": labels, "boxes": xywh}
        return [b["image"], *b["labels"], b["boxes"]], np.zeros(len(b["image"]))

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
        epoch = 0
        try:
            while not stop.is_set() and (epochs is None or epoch < epochs):
                for i in range(len(generator)):
                    if stop.is_set():
                        return
                    b = generator.get_batch(i)
                    q.put(b if transform is None else transform(b))
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
