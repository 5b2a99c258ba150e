"""Detect objects in one image and print the detections table: the
Inference notebook's journey as a command line.

Usage::

    python -m yolov4tpu_torch.examples.inference --weights yolov4.weights \
        --image street.jpeg [--classes class_names/coco_classes.txt] \
        [--bf16 | --int8] [--device cuda]

The model is YOLOv4 at full depth, 416x416: darknet ``.weights`` and
``.npz`` checkpoints carry no configuration, so it comes from the flags.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """The command line (``argv``: its arguments, default ``sys.argv``);
    prints and returns the detections DataFrame."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True,
                    help="AlexeyAB darknet yolov4.weights or .npz checkpoint")
    ap.add_argument("--image", required=True)
    ap.add_argument("--classes", default="class_names/coco_classes.txt")
    ap.add_argument("--bf16", action="store_true",
                    help="bfloat16 compute (default float32)")
    ap.add_argument("--int8", action="store_true",
                    help="int8 post-training quantization in bfloat16, "
                         "calibrated on the input image (calibrate on "
                         "representative frames in production)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..api import Yolov4
    from ..config import YoloConfig
    from ..device import resolve_device

    device = resolve_device(args.device)
    cfg = YoloConfig(compute_dtype="bfloat16" if (args.bf16 or args.int8)
                     else "float32")
    model = Yolov4(weight_path=args.weights, class_name_path=args.classes,
                   config=cfg, device=device)
    if args.int8:
        model.quantize(calib_paths=[args.image])
    detections = model.predict(args.image, plot_img=False)
    print(detections.to_string())
    return detections


if __name__ == "__main__":
    main()
