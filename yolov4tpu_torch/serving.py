"""Ahead-of-time export and serving of the inference pipeline
(``torch.export``).

Counterpart of ``yolov4tpu.serving``.  The whole BN-folded (or int8)
forward + decode + combined-NMS program, with the weights baked in and the
NMS thresholds as constants, is exported with ``torch.export`` and written
as one ``.pt2`` file::

    model = Yolov4(weight_path="yolov4.weights", class_name_path=...)
    serving.export_detector(model, "yolov4_b8.pt2", batch_size=8)
    ...
    detect = serving.load_detector("yolov4_b8.pt2")
    boxes, scores, classes, valid = detect(images)   # (8,416,416,3) float32

The program is specialised to one (batch, height, width) shape, one input
dtype and its platforms, the usual AOT serving contract.  Its kernels
are the port's ``torch.library`` custom ops (``yolov4tpu_torch::
suppress_rank`` for ``nms_impl="fast"``, ``yolov4tpu_torch::suppress``
for ``"pallas"``, and, in a program for ``("cuda",)`` alone,
``yolov4tpu_torch::conv_epilogue`` after every float conv), which resolve
only once this package has been imported: ``load_detector`` imports it.
An artifact exported for both platforms, ``platforms=("cuda", "cpu")``,
needs ``nms_impl="xla"`` (the plain torch NMS), ends its convs in the
plain epilogue, holds none of the port's ops and loads with torch alone.
The JAX package's StableHLO artifacts and these are not interchangeable.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from .config import require_yolov4
from .device import resolve_device
from .ops import epilogue, nms_cuda  # noqa: F401  (registers the custom ops)

_PLATFORMS = (("cuda",), ("cpu",), ("cuda", "cpu"))
_META = "yolov4tpu_torch.json"  # the artifact's platforms and signature


class _Detector(torch.nn.Module):
    """The inference function over folded params held as buffers, so that
    ``torch.export`` bakes them into the program's state."""

    def __init__(self, infer_fn, folded, iou_t: float, score_t: float):
        super().__init__()
        self._infer_fn = infer_fn
        self._thresholds = (iou_t, score_t)
        self._keys = [sorted(p) for p in folded["convs"]]
        for i, p in enumerate(folded["convs"]):
            for k in self._keys[i]:
                self.register_buffer(f"conv{i}_{k}", p[k])
        for j, t in enumerate(folded["s2d"]):
            self.register_buffer(f"s2d{j}", t)

    def forward(self, images):
        folded = {"convs": [{k: getattr(self, f"conv{i}_{k}") for k in keys}
                            for i, keys in enumerate(self._keys)],
                  "s2d": tuple(getattr(self, f"s2d{j}") for j in range(3))}
        return tuple(self._infer_fn(folded, images, *self._thresholds))


def export_detector(model, path: str, batch_size: int = 1,
                    platforms: Optional[Sequence[str]] = None,
                    iou_threshold: Optional[float] = None,
                    score_threshold: Optional[float] = None,
                    input_dtype: str = "float32"):
    """Export ``model``'s full inference pipeline and write it to ``path``.

    model: a built ``yolov4tpu_torch.Yolov4``; its prepared folded params,
    float or int8 (a quantized facade), are baked in.  Returns the
    ``torch.export.ExportedProgram``.

    platforms: ``("cuda",)``, ``("cpu",)`` or ``("cuda", "cpu")``; defaults
    to the model's device.  A single platform's program is traced on that
    device; a two-platform one needs ``nms_impl="xla"`` and is moved to the
    requested device when loaded.
    input_dtype: "float32" ([0,1] images) or "uint8" (the /255 is baked in,
    so serving hosts ship raw resized rasters, 4x less transfer).
    """
    if input_dtype not in ("float32", "uint8"):
        raise ValueError(
            f"input_dtype must be 'float32' or 'uint8', got {input_dtype!r}")
    cfg = model.config
    require_yolov4(cfg, "export_detector")
    iou_t = (cfg.iou_threshold if iou_threshold is None
             else float(iou_threshold))
    score_t = (cfg.score_threshold if score_threshold is None
               else float(score_threshold))
    platforms = (model.device.type,) if platforms is None else tuple(platforms)
    if platforms not in _PLATFORMS:
        raise ValueError(f"platforms must be one of {_PLATFORMS}, got "
                         f"{platforms}")
    # The NMS kernels are single-platform custom ops; a program for both
    # platforms takes the plain torch NMS.
    if cfg.nms_impl in ("fast", "pallas") and len(platforms) > 1:
        raise ValueError(
            "multi-platform export requires nms_impl='xla' (the NMS kernel "
            f"is single-platform); got nms_impl={cfg.nms_impl!r} "
            f"for platforms={platforms}")
    device = (model.device if len(platforms) > 1
              else resolve_device(platforms[0]))

    from .api import build_infer_fn
    infer_fn = build_infer_fn(cfg, model.num_classes, model._compute_dtype,
                              quantized=model._act_scales,
                              quantized_dataflow=model._q_dataflow)
    module = _Detector(infer_fn, model._folded, iou_t, score_t).to(device)
    h, w, c = model.img_size
    example = torch.zeros(
        (batch_size, h, w, c),
        dtype=torch.uint8 if input_dtype == "uint8" else torch.float32,
        device=device)
    exported = torch.export.export(module, (example,), strict=False)
    if platforms != ("cuda",):
        # The epilogue kernel runs only on the card: any other program ends
        # its convs in the eager expression, the same numbers.
        exported = exported.run_decompositions(
            {torch.ops.yolov4tpu_torch.conv_epilogue.default:
             epilogue.conv_epilogue_reference})
    meta = {"platforms": list(platforms), "device": str(example.device),
            "input_shape": list(example.shape), "input_dtype": input_dtype}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(exported, path, extra_files={_META: json.dumps(meta)})
    return exported


def load_detector(path: str, device="cuda") -> Callable:
    """Load an artifact written by :func:`export_detector` onto ``device``.

    Returns ``detect(images) -> (boxes, scores, classes,
    valid_detections)``, the contract of ``Yolov4.predict_batch``, with the
    artifact's fixed input signature as ``detect.input_shape`` and
    ``detect.input_dtype`` (a numpy dtype); input of another shape or dtype
    raises ``ValueError``.  Raises if ``device`` is not among the
    artifact's platforms.  Importing this module imported the port, which
    resolves the NMS custom ops the artifact may hold.
    """
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    extra = {_META: ""}
    exported = torch.export.load(path, extra_files=extra)
    meta = json.loads(extra[_META])
    if device.type not in meta["platforms"]:
        raise ValueError(f"{path} was exported for {meta['platforms']}, "
                         f"not {device.type}")
    if torch.device(meta["device"]) != device:
        from torch.export.passes import move_to_device_pass
        exported = move_to_device_pass(exported, device)
    module = exported.module()
    shape = tuple(meta["input_shape"])
    dtype = torch.uint8 if meta["input_dtype"] == "uint8" else torch.float32

    def detect(images):
        x = torch.as_tensor(images)
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"the artifact takes {meta['input_dtype']} images of shape "
                f"{shape}, got {x.dtype} {tuple(x.shape)}")
        with torch.inference_mode():
            return module(x.to(device))

    detect.input_shape = shape
    detect.input_dtype = np.dtype(meta["input_dtype"])
    return detect
