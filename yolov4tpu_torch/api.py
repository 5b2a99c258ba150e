"""``Yolov4`` — the reference-compatible user facade, on PyTorch and CUDA.

Counterpart of ``yolov4tpu.api`` for inference, evaluation, training and
persistence: construction from darknet ``.weights``, an ``.npz``
checkpoint, a keras ``.h5`` file or a seeded random init; ``save_model``
and ``load_model``; ``predict``, ``predict_img``, ``predict_batch``,
``predict_paths``, ``predict_raw``, ``predict_nonms`` (stretch or
letterbox preprocessing); the mAP pipeline ``export_gt`` /
``export_prediction`` / ``eval_map``; ``trainer``, ``fit`` and
``sync_from_trainer``; int8 post-training quantization, ``quantize`` and
``dequantize`` (``models.quantize``); inference sharded on the batch over
the ranks of a process group, ``distribute`` (``parallel.mesh``).  The
inference path is the BN-folded forward (models.network) -> fused decode
(ops.detect) -> candidate NMS with the CUDA suppression kernel
(ops.nms_cuda); with ``nms_impl="pallas"`` it is decode -> per-class
top-K -> the sorted CUDA suppression kernel
(``nms_cuda.combined_nms_sorted``).  Training is ``train.Trainer``.

The entry points run on the card: ``device="cuda"`` is the default and
raises on a host without CUDA.  ``device="cpu"`` runs the same code on the
CPU, where the suppression kernel's plain torch version stands in for it.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from . import checkpoint as ckpt
from . import evalmap, weights
from .config import DEFAULT_CONFIG, YoloConfig
from .device import resolve_device, to_device_async
from .models import head, network
from .ops.detect import detect_fused
from .ops.nms import combined_nms
from .ops.nms_cuda import combined_nms_sorted
from .data.pipeline import letterbox_resize
from .parallel.mesh import barrier, gather_rows, replicate
from .train import Trainer, tree_map
from .utils.stream import threaded_map
from .utils.visualize import draw_bbox, get_detection_data

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _select_raw_apply(scales, dataflow: str):
    """The float-vs-int8 forward, shared by every builder of a raw-grid
    function: None -> the folded float forward; a calibration-scales dict
    (``models.quantize.calibrate``) -> the int8 forward bound to them."""
    if scales is not None:
        from .models.quantize import apply_quantized
        return functools.partial(apply_quantized, scales=scales,
                                 dataflow=dataflow)
    return network.apply_folded


def build_infer_fn(cfg: YoloConfig, num_classes: int, compute_dtype,
                   quantized: Optional[dict] = None,
                   quantized_dataflow: str = "int8"):
    """End-to-end inference fn: (folded, images, iou_t, score_t) ->
    (boxes (B,T,4), scores (B,T), classes (B,T), valid_detections (B,)).

    ``images`` is (B, H, W, 3) NHWC on the folded params' device: float in
    [0, 1], or uint8 in [0, 255], divided by 255 on the device.

    quantized: None for the float path, or the calibration-scales dict
    (``models.quantize.calibrate``); then ``folded`` holds int8 params
    (``prepare_folded`` of ``quantize_folded``'s) and the forward is the
    int8 one with those static scales.  quantized_dataflow: "int8" (inter-op
    tensors stay int8) or "bf16".
    """
    if cfg.nms_impl not in ("fast", "xla", "pallas"):
        raise ValueError(f"unknown nms_impl {cfg.nms_impl!r}")
    # "pallas" (the JAX package's name) is per-class top-K + the sorted
    # suppression kernel; "xla" the plain exact combined NMS.
    exact_nms = (combined_nms_sorted if cfg.nms_impl == "pallas"
                 else combined_nms)
    anchors = cfg.anchors_grouped
    strides, xyscale, img_size = cfg.strides, cfg.xyscale, cfg.img_size
    apply = _select_raw_apply(quantized, quantized_dataflow)

    @torch.inference_mode()
    def infer_fn(folded, images, iou_t, score_t):
        if images.dtype == torch.uint8:
            images = images.to(torch.float32) / 255.0
        raws = apply(folded, images, num_classes, compute_dtype,
                     csp_repeats=cfg.csp_repeats, s2d_stem=cfg.s2d_stem)
        if cfg.nms_impl == "fast":
            return detect_fused(
                raws, anchors, num_classes, strides, xyscale, img_size[0],
                iou_threshold=iou_t, score_threshold=score_t,
                max_per_class=cfg.max_boxes, max_total=cfg.max_boxes,
                candidates=cfg.nms_pre_top_k)
        outs = head.decode_head(raws, anchors, num_classes, strides, xyscale)
        boxes, scores = head.flatten_boxes_scores(outs, img_size[0],
                                                  num_classes)
        return exact_nms(
            boxes, scores, iou_threshold=iou_t, score_threshold=score_t,
            max_per_class=cfg.max_boxes, max_total=cfg.max_boxes,
            pre_top_k=cfg.nms_pre_top_k)

    return infer_fn


class Yolov4:
    """YOLOv4 detector with a reference-compatible API surface."""

    def __init__(self, weight_path: Optional[str] = None,
                 class_name_path: str = "coco_classes.txt",
                 config: YoloConfig = DEFAULT_CONFIG, seed: int = 0,
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(config, dict):  # accept reference-style dicts
            config = _config_from_dict(config)
        self.config = config
        with open(class_name_path) as f:
            self.class_names = [line.strip() for line in f.readlines()]
        self.num_classes = len(self.class_names)
        if self.num_classes == 0:
            raise ValueError(f"no classes in {class_name_path}")
        self.img_size = config.img_size
        self.weight_path = weight_path
        self.anchors = config.anchors_grouped
        self.xyscale = config.xyscale
        self.strides = config.strides
        self.output_sizes = list(config.grid_sizes())
        self.max_boxes = config.max_boxes
        self.iou_loss_thresh = config.iou_loss_thresh
        self.class_color = {name: list(np.random.random(size=3) * 255)
                            for name in self.class_names}
        self._seed = seed
        self._trainer = None
        self._act_scales = None  # set by quantize(): int8 inference on
        self._q_dataflow = "int8"
        self._mesh = None        # set by distribute(): sharded inference
        self.build_model(load_pretrained=bool(weight_path))

    # ------------------------------------------------------------------
    # Build / weights
    # ------------------------------------------------------------------
    def build_model(self, load_pretrained: bool = True):
        """Initialise (or load) params and build the inference function."""
        if load_pretrained and self.weight_path:
            if tuple(self.config.csp_repeats) != (1, 2, 8, 8, 4):
                raise ValueError(
                    "pretrained weights require the full CSPDarknet53 depth "
                    "(csp_repeats=(1,2,8,8,4)); shallow variants train from "
                    "scratch")
            if self.weight_path.endswith(".weights"):
                self.params, self.state = weights.load_darknet_weights(
                    self.weight_path, self.num_classes)
            elif self.weight_path.endswith((".npz", ".h5ckpt", ".ckpt")):
                self.params, self.state, _, _ = ckpt.load_npz(
                    self.weight_path)
            elif self.weight_path.endswith((".h5", ".hdf5")):
                # Reference-era keras weight files.
                self.params, self.state = weights.load_keras_h5(
                    self.weight_path, self.num_classes)
            else:
                raise ValueError(f"unsupported weight file: {self.weight_path}")
            print(f"load from {self.weight_path}")
        else:
            self.params, self.state, _ = network.init(
                self.num_classes, self.img_size[0], seed=self._seed,
                csp_repeats=self.config.csp_repeats)
        self._refresh_inference()

    def _refresh_inference(self, folded=None):
        """Fold BN (``quantize`` passes its fold through ``folded``),
        requantize with the kept calibration scales on a quantized facade,
        place the params and build the raw and inference functions.  On a
        mesh (``distribute``) every rank takes rank 0's fold and scales
        before quantizing, so every rank serves rank 0's weights: each
        rank calls this at the same point."""
        if self.config.compute_dtype not in _DTYPES:
            raise ValueError(
                f"unknown compute_dtype {self.config.compute_dtype!r}")
        self._compute_dtype = _DTYPES[self.config.compute_dtype]
        if folded is None:
            folded = network.fold_bn(self.params, self.state)
        if self._mesh is not None:
            replicate({"folded": folded, "scales": self._act_scales},
                      self._mesh)
        if self._act_scales is not None:
            from .models.quantize import quantize_folded
            folded = quantize_folded(folded, self._act_scales,
                                     self.num_classes,
                                     self.config.csp_repeats)
        self._folded = network.prepare_folded(folded, self.device,
                                              self._compute_dtype)
        self._raw_apply = _select_raw_apply(self._act_scales,
                                            self._q_dataflow)
        self._infer_fn = build_infer_fn(self.config, self.num_classes,
                                        self._compute_dtype,
                                        quantized=self._act_scales,
                                        quantized_dataflow=self._q_dataflow)

    def sync_params(self, params, state):
        """Swap in new (params, state) dictionaries (CPU tensors) and refold;
        a quantized facade requantizes with its kept scales."""
        self.params, self.state = params, state
        self._refresh_inference()

    def sync_from_trainer(self, trainer=None):
        """Pull trained params/state back into the inference path (from the
        given Trainer, or the one this facade created via ``fit``)."""
        trainer = trainer if trainer is not None else self._trainer
        if trainer is not None:
            # Copies, also on the CPU: later steps update the trainer's
            # tensors in place.
            def cpu(tree):
                return tree_map(lambda t: t.detach().to("cpu", copy=True),
                                tree)
            self.sync_params(cpu(trainer.params), cpu(trainer.state))

    def quantize(self, calib_imgs=None,
                 calib_paths: Optional[Sequence[str]] = None,
                 dataflow: str = "int8", calib_method: str = "max",
                 calib_percentile: float = 99.9):
        """Switch inference to int8 (post-training quantization).

        Calibrates per-tensor activation scales on representative images in
        the compute dtype, on the facade's device, and rebuilds the
        inference functions over int8 weights (``models.quantize``).
        Opt-in: int8 trades the float path's 1e-3 per-box fidelity for the
        int8 GEMMs; validate mAP on your evaluation set after quantizing.

        calib_imgs: (N,H,W,3) float [0,1] model-space images, and/or
        calib_paths: image files run through ``preprocess_img``.
        dataflow: "int8" keeps inter-op activations int8; "bf16" is the
        per-conv scheme.  calib_method: "max" or "percentile" (clip
        |activation| at ``calib_percentile``; see ``quantize.calibrate``).
        """
        if dataflow not in ("int8", "bf16"):
            raise ValueError(
                f"dataflow must be 'int8' or 'bf16', got {dataflow!r}")
        import cv2
        from .models.quantize import calibrate
        imgs = []
        if calib_imgs is not None:
            imgs.append(np.asarray(calib_imgs, np.float32))
        if calib_paths:
            imgs.append(np.stack([
                self.preprocess_img(cv2.cvtColor(_imread(p),
                                                 cv2.COLOR_BGR2RGB))
                for p in calib_paths]).astype(np.float32))
        if not imgs:
            raise ValueError("quantize() needs calib_imgs and/or calib_paths")
        folded = network.fold_bn(self.params, self.state)
        self._act_scales = calibrate(
            network.prepare_folded(folded, self.device, self._compute_dtype),
            np.concatenate(imgs), self.num_classes, self._compute_dtype,
            csp_repeats=self.config.csp_repeats, method=calib_method,
            percentile=calib_percentile)
        self._q_dataflow = dataflow
        self._refresh_inference(folded)
        return self

    def dequantize(self):
        """Return inference to the full-precision folded path."""
        self._act_scales = None
        self._refresh_inference()
        return self

    def distribute(self, num_devices: Optional[int] = None,
                   axis: str = "batch"):
        """Shard batched inference over the ranks of the process group
        (``parallel.init_distributed`` first, or torchrun), one process per
        device, as data-parallel training runs.

        ``axis="batch"``: every rank passes ``predict_batch`` the same global
        batch, runs its own contiguous rows of it (the batch padded with
        zero images to a multiple of the rank count) and gets every rank's
        detections back through one ``all_gather``; the folded weights are
        rank 0's, on every refresh.  Files (``export_prediction``, the
        video tool) are written by rank 0.  ``num_devices`` (default
        ``config.num_devices``) must equal the world size.  Every rank
        calls this, and every later inference call, at the same point.
        ``axis="spatial"`` (the image's rows sharded) is not ported yet.
        """
        if axis not in ("batch", "spatial"):
            raise ValueError(
                f"axis must be 'batch' or 'spatial', got {axis!r}")
        if axis == "spatial":
            raise NotImplementedError(
                "spatial-sharded inference is not ported yet "
                "(ROADMAP.md queue A item 14c)")
        from .parallel.mesh import make_mesh
        self._mesh = make_mesh(num_devices or self.config.num_devices,
                               self.device)
        self._refresh_inference()
        return self

    # ------------------------------------------------------------------
    # Persistence
    # ------------------------------------------------------------------
    def save_model(self, path: str):
        """Save params + BN state (reference save_model, models.py:92-93): a
        darknet ``.weights`` file, else an ``.npz`` checkpoint in the JAX
        package's layout (``.npz`` is appended to a path without it).  A
        quantized facade writes its float weights, as the JAX package's
        does."""
        if path.endswith(".weights"):
            weights.save_darknet_weights(self.params, self.state, path)
        else:
            ckpt.save_npz(path if path.endswith(".npz") else path + ".npz",
                          *network.params_to_jax(self.params, self.state))

    def load_model(self, path: str):
        """Restore a ``.weights`` file or an ``.npz`` checkpoint and refold
        onto the facade's device; keeps the configured NMS thresholds
        (unlike reference models.py:86-90)."""
        if path.endswith(".weights"):
            self.params, self.state = weights.load_darknet_weights(
                path, self.num_classes)
        else:
            self.params, self.state, _, _ = ckpt.load_npz(path)
        self._refresh_inference()

    # ------------------------------------------------------------------
    # Inference
    # ------------------------------------------------------------------
    def preprocess_img(self, img):
        """Resize + /255 (reference models.py:95-98): stretch by default,
        aspect-preserving gray letterbox when config.letterbox is set."""
        return self._preprocess_with_transform(img)[0]

    def _preprocess_with_transform(self, img):
        """(model-space float img, letterbox transform or None)."""
        import cv2
        if self.config.letterbox:
            out, _, t = letterbox_resize(np.asarray(img), self.img_size[:2],
                                         np.zeros((0, 5), np.float32))
            return out, (t, self.img_size[:2])
        h, w = self.img_size[:2]  # cv2.resize takes dsize as (width, height)
        return cv2.resize(np.asarray(img), (w, h)) / 255.0, None

    def _batch_from_rgb(self, raws):
        """The streaming loader's batch (``predict_paths``): RGB rasters ->
        (images on the model's device, per-image letterbox transforms).

        With config.transfer_uint8 (and no letterbox) it ships the resized
        uint8 rasters, divided by 255 on the device: the same raster bytes
        the float path divides, as it resizes in uint8 before dividing.
        Letterbox keeps the float wire (its gray padding is float).  The
        caller runs this in its producer thread: the copy to the card comes
        from pinned memory without blocking, so batch N+1's copy overlaps
        batch N's inference.  On a mesh the batch stays on the host, and
        ``predict_batch`` copies only this rank's rows.  Unlike the JAX
        package's, the batch is not padded to a fixed size (``predict_batch``
        pads only on a mesh).
        """
        import cv2
        h, w = self.img_size[:2]
        u8_wire = self.config.transfer_uint8 and not self.config.letterbox
        imgs = np.zeros((len(raws), h, w, 3),
                        np.uint8 if u8_wire else np.float32)
        transforms = []
        for j, raw in enumerate(raws):
            if u8_wire:
                imgs[j], t = cv2.resize(np.asarray(raw), (w, h)), None
            else:
                imgs[j], t = self._preprocess_with_transform(raw)
            transforms.append(t)
        if self._mesh is not None:
            return imgs, transforms
        return to_device_async(imgs, self.device), transforms

    def _raw(self, images):
        with torch.inference_mode():
            return self._raw_apply(
                self._folded, images, self.num_classes, self._compute_dtype,
                csp_repeats=self.config.csp_repeats,
                s2d_stem=self.config.s2d_stem)

    def predict_batch(self, imgs, iou_threshold: Optional[float] = None,
                      score_threshold: Optional[float] = None):
        """Batched inference: (B,H,W,3) float [0,1] — or uint8 [0,255],
        divided by 255 on the device (4x less host-to-device traffic) — as
        a numpy array or tensor -> (boxes_norm, scores, classes,
        valid_detections), tensors on the model's device.

        The JAX package pads ragged batches to bound XLA recompiles; an
        eager forward has nothing to recompile, and padding is exact, so
        the port does not pad on one device.  On a mesh (``distribute``)
        every rank passes the same batch of b images: it is padded with
        zero images to the least multiple of the rank count, each rank
        copies and runs its own contiguous rows, and every rank returns the
        whole batch's outputs, trimmed to b.
        """
        iou_t = (self.config.iou_threshold if iou_threshold is None
                 else iou_threshold)
        score_t = (self.config.score_threshold if score_threshold is None
                   else score_threshold)
        imgs, mesh = torch.as_tensor(imgs), self._mesh
        if mesh is None:
            return self._infer_fn(self._folded, _wire(imgs).to(self.device),
                                  iou_t, score_t)
        b = imgs.shape[0]
        rows = -(-b // mesh.size)
        mine = imgs[mesh.rank * rows:(mesh.rank + 1) * rows]
        if mine.shape[0] < rows:
            mine = torch.cat([mine, mine.new_zeros(
                (rows - mine.shape[0], *mine.shape[1:]))])
        out = self._infer_fn(self._folded, _wire(mine).to(self.device),
                             iou_t, score_t)
        return tuple(o[:b] for o in gather_rows(out, mesh))

    def predict_paths(self, img_paths, bs: int = 8,
                      iou_threshold: Optional[float] = None,
                      score_threshold: Optional[float] = None):
        """Streaming batched inference over image files.

        Yields ``(path, detections_DataFrame)`` per image, in order.  Host
        decode and resize of the next batch run in a producer thread
        (utils.stream.threaded_map) while the card runs the current one.
        """
        img_paths = list(img_paths)

        def load(paths):
            raws = [_imread(p)[:, :, ::-1] for p in paths]
            imgs, transforms = self._batch_from_rgb(raws)
            return paths, imgs, raws, transforms

        chunks = [img_paths[s:s + bs] for s in range(0, len(img_paths), bs)]
        for paths, imgs, raws, transforms in threaded_map(load, chunks):
            outs = [o.cpu().numpy() for o in self.predict_batch(
                imgs, iou_threshold, score_threshold)]
            for k, path in enumerate(paths):
                yield path, get_detection_data(
                    img=raws[k], model_outputs=[o[k:k + 1] for o in outs],
                    class_names=self.class_names,
                    letterbox_transform=transforms[k])

    def _detections(self, raw_img, iou_threshold=None, score_threshold=None):
        img, transform = self._preprocess_with_transform(raw_img)
        out = self.predict_batch(np.expand_dims(img, axis=0), iou_threshold,
                                 score_threshold)
        return get_detection_data(img=raw_img,
                                  model_outputs=[o.cpu().numpy() for o in out],
                                  class_names=self.class_names,
                                  letterbox_transform=transform)

    def predict_img(self, raw_img, random_color=True, plot_img=True,
                    figsize=(10, 10), show_text=True, return_output=False):
        """Single-image inference + drawing (reference models.py:109-123)."""
        detections = self._detections(raw_img)
        output_img = draw_bbox(raw_img, detections, cmap=self.class_color,
                               random_color=random_color, figsize=figsize,
                               show_text=show_text, show_img=plot_img)
        if return_output:
            return output_img, detections
        return detections

    def predict(self, img_path: str, random_color=True, plot_img=True,
                figsize=(10, 10), show_text=True):
        """Path -> detections DataFrame (reference models.py:125-127)."""
        return self.predict_img(_imread(img_path)[:, :, ::-1], random_color,
                                plot_img, figsize, show_text)

    def predict_raw(self, img_path: str):
        """Raw head outputs for debugging (reference models.py:509-514):
        the three NHWC grids as numpy arrays.  Like the reference, the image
        is fed in cv2's BGR order."""
        img = self.preprocess_img(_imread(img_path))
        imgs = torch.as_tensor(np.expand_dims(img, axis=0),
                               dtype=torch.float32).to(self.device)
        return [o.cpu().numpy() for o in self._raw(imgs)]

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def trainer(self, schedule=None):
        """The facade's Trainer (created on first use), holding its params
        on the facade's device; with ``config.num_devices > 1`` a
        data-parallel one over the process group (``parallel.mesh``:
        ``init_distributed`` first)."""
        if self._trainer is None:
            self._trainer = Trainer(self.config, self.num_classes,
                                    self.params, self.state,
                                    schedule=schedule, device=self.device)
        return self._trainer

    def fit(self, train_data_gen, epochs: int, val_data_gen=None,
            initial_epoch: int = 0, callbacks=None, verbose: bool = True,
            resume_dir: Optional[str] = None):
        """Train (reference models.py:100-107 — without its val=None crash),
        then refold so ``predict_batch`` serves the trained weights."""
        history = self.trainer().fit(
            train_data_gen, epochs, val_gen=val_data_gen,
            initial_epoch=initial_epoch, callbacks=callbacks,
            verbose=verbose, resume_dir=resume_dir)
        self.sync_from_trainer()
        return history

    def predict_nonms(self, img_path: str, iou_threshold: float = 0.413,
                      score_threshold: float = 0.1):
        """Inference with caller-supplied NMS thresholds
        (reference models.py:516-529; BGR input, as there)."""
        raw_img = _imread(img_path)
        detections = self._detections(raw_img, iou_threshold, score_threshold)
        draw_bbox(raw_img, detections, cmap=self.class_color,
                  random_color=True)
        return detections

    # ------------------------------------------------------------------
    # mAP evaluation pipeline
    # ------------------------------------------------------------------
    def export_gt(self, annotation_path: str, gt_folder_path: str):
        evalmap.export_gt(annotation_path, gt_folder_path, self.class_names)

    def export_prediction(self, annotation_path: str, pred_folder_path: str,
                          img_folder_path: str, bs: int = 2,
                          verbose: bool = True):
        """Per-image prediction files for ``eval_map``.  On a mesh every
        rank makes the same ``predict_batch`` calls and rank 0 alone writes;
        when the call returns, every file is on disk for every rank."""
        mesh = self._mesh
        writes = mesh is None or mesh.rank == 0
        evalmap.export_prediction(
            self.predict_batch, annotation_path, pred_folder_path,
            img_folder_path, self.img_size[:2], self.class_names, bs=bs,
            verbose=verbose and writes, letterbox=self.config.letterbox,
            transfer_uint8=self.config.transfer_uint8,
            place_fn=(None if mesh is not None else
                      lambda imgs: to_device_async(imgs, self.device)),
            write=writes)
        if mesh is not None:
            barrier(mesh)

    def eval_map(self, gt_folder_path: str, pred_folder_path: str,
                 temp_json_folder_path: str, output_files_path: str,
                 plot: bool = True, verbose: bool = True):
        return evalmap.eval_map(gt_folder_path, pred_folder_path,
                                temp_json_folder_path, output_files_path,
                                plot=plot, verbose=verbose)


def _wire(imgs: torch.Tensor) -> torch.Tensor:
    """A batch as ``infer_fn`` takes it: uint8 as it is, else float32."""
    return imgs if imgs.dtype == torch.uint8 else imgs.to(torch.float32)


def _imread(path: str):
    import cv2
    img = cv2.imread(path)
    if img is None:
        raise FileNotFoundError(path)
    return img


def _config_from_dict(d: dict) -> YoloConfig:
    """Translate a reference-style yolo_config dict into a YoloConfig."""
    kw = {}
    mapping = {
        "img_size": "img_size", "anchors": "anchors", "strides": "strides",
        "xyscale": "xyscale", "iou_loss_thresh": "iou_loss_thresh",
        "batch_size": "batch_size", "num_gpu": "num_devices",
        "max_boxes": "max_boxes", "iou_threshold": "iou_threshold",
        "score_threshold": "score_threshold",
    }
    for src, dst in mapping.items():
        if src in d:
            v = d[src]
            kw[dst] = tuple(v) if isinstance(v, list) else v
    return YoloConfig(**kw)
