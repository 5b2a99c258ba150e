"""Export a detector for serving ahead of time, then run the artifact.

The artifact is a ``torch.export`` program (``.pt2``) with the weights,
the decode and the NMS baked in; serving it needs torch and this package
(its NMS kernels are the package's custom ops), not the weight files.

Usage::

    # export (on the platform it will serve on)
    python -m yolov4tpu_torch.examples.export_serving export \
        --weights yolov4.weights --out yolov4_b8.pt2 --batch 8

    # serve / smoke-run the artifact
    python -m yolov4tpu_torch.examples.export_serving run \
        --artifact yolov4_b8.pt2 --image street.jpeg
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def cmd_export(args):
    """Write the artifact; returns the ``ExportedProgram``."""
    from .. import serving
    from ..api import Yolov4
    from ..config import YoloConfig

    cfg = YoloConfig(compute_dtype="bfloat16" if args.bf16 else "float32")
    model = Yolov4(weight_path=args.weights, class_name_path=args.classes,
                   config=cfg, device=args.device)
    exported = serving.export_detector(
        model, args.out, batch_size=args.batch,
        input_dtype="uint8" if args.uint8 else "float32")
    size_mb = os.path.getsize(args.out) / 1e6
    print(f"exported {args.out} ({size_mb:.1f} MB, batch={args.batch})")
    return exported


def cmd_run(args):
    """Detect on one image in slot 0 of the artifact's batch; returns the
    outputs as numpy arrays (boxes, scores, classes, valid)."""
    import cv2
    import numpy as np

    from .. import serving

    detect = serving.load_detector(args.artifact, device=args.device)
    img = cv2.imread(args.image)
    if img is None:
        raise FileNotFoundError(args.image)
    img = img[:, :, ::-1]
    # The artifact carries its fixed input signature; build the batch from
    # it (a uint8-wire artifact rejects float input and vice versa).
    batch, h, w, _ = detect.input_shape
    x = np.zeros(detect.input_shape, detect.input_dtype)
    r = cv2.resize(img, (w, h))
    x[0] = r if detect.input_dtype == np.uint8 else r.astype(np.float32) / 255.0
    boxes, scores, classes, valid = [o.cpu().float().numpy()
                                     for o in detect(x)]
    n = int(valid[0])
    print(f"{n} detections")
    for b, s, c in zip(boxes[0, :n], scores[0, :n], classes[0, :n]):
        print(f"  class={int(c)} score={s:.3f} box={np.round(b, 3)}")
    return boxes, scores, classes, valid


def main(argv: Optional[Sequence[str]] = None):
    """The command line (``argv``: its arguments, default ``sys.argv``);
    returns what the subcommand returns."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    e = sub.add_parser("export")
    e.add_argument("--weights", required=True)
    e.add_argument("--classes", default="class_names/coco_classes.txt")
    e.add_argument("--out", required=True)
    e.add_argument("--batch", type=int, default=8)
    e.add_argument("--bf16", action="store_true")
    e.add_argument("--uint8", action="store_true",
                   help="artifact takes raw uint8 rasters (/255 baked in; "
                        "4x less transfer per request)")

    r = sub.add_parser("run")
    r.add_argument("--artifact", required=True)
    r.add_argument("--image", required=True)

    for p in (e, r):
        p.add_argument("--device", default="cuda",
                       help="torch device: cuda (default) or cpu; the "
                            "artifact runs on the platform it was "
                            "exported for")
    args = ap.parse_args(argv)

    from ..device import resolve_device

    args.device = resolve_device(args.device)
    return cmd_export(args) if args.cmd == "export" else cmd_run(args)


if __name__ == "__main__":
    main()
