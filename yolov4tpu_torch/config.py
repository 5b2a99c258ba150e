"""Typed, frozen configuration for the PyTorch/CUDA YOLOv4 port.

Same fields and defaults as ``yolov4tpu.config.YoloConfig``, so one set of
hyperparameters describes a model in either package.  The defaults
reproduce the tf.keras reference's ``yolo_config`` (reference config.py).
``num_devices > 1`` trains data-parallel over a ``torch.distributed``
process group of that size (``parallel.mesh``).

``arch`` names the network: ``"yolov4"`` (the default, 3 scales of 3
anchors) or ``"yolov4-p6"``, YOLOv4-P6 of Scaled-YOLOv4 (arXiv:2011.08036;
4 scales of 4 anchors at strides 8-64, its own decode; inference only).
``p6_config`` gives P6's published settings.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    """Hyperparameters for model topology, training and inference."""

    # --- Basic (reference config.py:3-6) ---
    arch: str = "yolov4"
    img_size: Tuple[int, int, int] = (416, 416, 3)
    anchors: Tuple[int, ...] = (
        12, 16, 19, 36, 40, 28, 36, 75, 76, 55, 72, 146, 142, 110, 192, 243,
        459, 401,
    )
    strides: Tuple[int, ...] = (8, 16, 32)
    xyscale: Tuple[float, ...] = (1.2, 1.1, 1.05)

    # --- Training (reference config.py:9-11) ---
    iou_loss_thresh: float = 0.5
    batch_size: int = 8
    num_devices: int = 1
    learning_rate: float = 1e-4
    loss_box_weight: float = 3.54
    loss_conf_weight: float = 64.3
    loss_prob_weight: float = 1.0
    label_smoothing: float = 0.0
    use_mosaic: bool = False
    use_cutmix: bool = False
    use_hflip: bool = False
    use_color_jitter: bool = False
    multi_scale: Optional[Tuple[int, int]] = None
    multi_scale_interval: int = 10
    sat_epsilon: float = 0.0
    grad_accum_steps: int = 1
    encode_on_device: bool = False
    transfer_uint8: bool = False
    fused_optimizer: bool = False
    bn_stats_gradient: bool = True
    pallas_wgrad: bool = False

    # Aspect-preserving letterbox resize instead of the reference's stretch
    # resize, for inference, the mAP export and DataGenerator's training
    # batches (gray 0.5 bars; colour jitter runs before the resize so the
    # bars stay exactly 0.5).
    letterbox: bool = False

    # --- Host ingest ---
    num_workers: Optional[int] = None
    fast_decode: bool = True

    # Space-to-depth stem for BN-folded inference: the two stem convs
    # (3->32, 32->64 downsample) run as dense convs in 2x2 block space — an
    # exact reparametrisation (models.network._s2d_stem_kernels).
    s2d_stem: bool = True

    # --- Inference (reference config.py:14-16) ---
    max_boxes: int = 100
    iou_threshold: float = 0.413
    score_threshold: float = 0.3

    # Residual depth of the five CSP stages; (1,2,8,8,4) is the reference
    # CSPDarknet53.  Darknet .weights import requires the full depth.  For
    # "yolov4-p6": the six backbone stages' and the neck's (every neck
    # BottleneckCSP2 has the same), P6_DEPTH published.
    csp_repeats: Tuple[int, ...] = (1, 2, 8, 8, 4)
    compute_dtype: str = "float32"  # "bfloat16" for fast inference
    nms_pre_top_k: int = 256  # candidates considered by NMS
    # NMS implementation: "fast" = global candidate reduction + the CUDA
    # suppression kernel (ops.nms_cuda), "xla" = the plain-torch exact
    # per-class combined NMS (ops.nms; named after the JAX package's
    # option), "pallas" = per-class top-k + the sorted CUDA suppression
    # kernel (ops.nms_cuda.combined_nms_sorted; named after the JAX
    # package's option, exact for any number of boxes above the threshold).
    nms_impl: str = "fast"

    def __post_init__(self):
        if self.arch not in ARCHS:
            raise ValueError(f"arch must be one of {sorted(ARCHS)}, got "
                             f"{self.arch!r}")
        scales, per_scale, depth = ARCHS[self.arch]
        if self.img_size[0] != self.img_size[1]:
            raise ValueError("img_size must be square")
        if len(self.strides) != scales or len(self.xyscale) != scales:
            raise ValueError(f"{self.arch} has {scales} scales: strides and "
                             f"xyscale need {scales} entries")
        if self.img_size[0] % self.strides[-1] != 0:
            raise ValueError("img_size must be a multiple of the last stride")
        if len(self.anchors) != 2 * scales * per_scale:
            raise ValueError(f"expected {scales * per_scale} anchor (w, h) "
                             f"pairs for {self.arch}")
        if len(self.csp_repeats) != depth:
            raise ValueError(f"{self.arch} takes {depth} csp_repeats")

    # --- Derived quantities ---
    @property
    def num_scales(self) -> int:
        return len(self.strides)

    @property
    def anchors_per_scale(self) -> int:
        return ARCHS[self.arch][1]

    @property
    def anchors_grouped(self) -> np.ndarray:
        """Anchors as (num_scales, anchors_per_scale, 2) pixel-unit
        array."""
        return np.asarray(self.anchors, dtype=np.float32).reshape(
            self.num_scales, self.anchors_per_scale, 2)

    @property
    def anchors_flat(self) -> np.ndarray:
        """Anchors as (num_scales * anchors_per_scale, 2)."""
        return np.asarray(self.anchors, dtype=np.float32).reshape(-1, 2)

    def grid_sizes(self, img_size: int | None = None) -> Tuple[int, ...]:
        """Feature-grid side length per scale."""
        side = self.img_size[0] if img_size is None else img_size
        return tuple(side // s for s in self.strides)

    def replace(self, **kw) -> "YoloConfig":
        return dataclasses.replace(self, **kw)


# arch -> (scales, anchors a scale, entries of csp_repeats)
ARCHS = {"yolov4": (3, 3, 5), "yolov4-p6": (4, 4, 7)}

P6_DEPTH = (1, 3, 15, 15, 7, 7, 3)


def p6_config(**overrides) -> YoloConfig:
    """YOLOv4-P6's published settings (ScaledYOLOv4, yolov4-large branch:
    models/yolov4-p6.yaml and detect.py): 1280 pixels, its 16 anchors at
    strides 8-64, the decode's xy scale 2, score 0.4 and IoU 0.5; any field
    overridden by keyword."""
    kw = dict(
        arch="yolov4-p6", img_size=(1280, 1280, 3),
        anchors=(13, 17, 31, 25, 24, 51, 61, 45,
                 61, 45, 48, 102, 119, 96, 97, 189,
                 97, 189, 217, 184, 171, 384, 324, 451,
                 324, 451, 545, 357, 616, 618, 1024, 1024),
        strides=(8, 16, 32, 64), xyscale=(2.0, 2.0, 2.0, 2.0),
        csp_repeats=P6_DEPTH, score_threshold=0.4, iou_threshold=0.5)
    kw.update(overrides)
    return YoloConfig(**kw)


def require_yolov4(config: YoloConfig, what: str) -> None:
    """Raise where ``what`` runs the YOLOv4 graph only and ``config`` names
    another architecture."""
    if config.arch != "yolov4":
        raise NotImplementedError(
            f"{what} supports arch 'yolov4' only, not {config.arch!r}: "
            f"{config.arch} runs inference (predict_batch and the paths "
            f"built on it) from params given by sync_params or a seed")


DEFAULT_CONFIG = YoloConfig()
