"""Score a checkpoint's VOC mAP@0.5 on an annotated image set: export the
ground truth, export the predictions, score them (the reference's
evaluation flow) as a command line.

Usage::

    python -m yolov4tpu_torch.examples.eval --weights ckpt.npz \
        --anno anno-test.txt --classes classes.txt --imgdir imgs/ \
        [--outdir eval/] [--bs 16] [--img-size 416] [--device cuda]

The last line printed is ``{"mAP": ..., "per_class": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """The command line (``argv``: its arguments, default ``sys.argv``);
    returns ``eval_map``'s scores."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--weights", required=True,
                    help="darknet .weights or .npz checkpoint")
    ap.add_argument("--anno", required=True, help="annotation txt to score")
    ap.add_argument("--classes", required=True,
                    help="class names, one per line; the evaluation files "
                         "split on whitespace, so a name with a space "
                         "breaks them: write such names with underscores")
    ap.add_argument("--imgdir", required=True)
    ap.add_argument("--outdir", default="eval",
                    help="working root; writes ground_truth/ pred_result/ "
                         "json/ result/ beneath it")
    ap.add_argument("--bs", type=int, default=16, help="inference batch")
    ap.add_argument("--img-size", type=int, default=416,
                    help="square input size the checkpoint was trained at "
                         "(.npz files carry no config; must match)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--letterbox", action="store_true",
                    help="aspect-preserving resize (must match training)")
    ap.add_argument("--int8", action="store_true",
                    help="score the int8-quantized path (calibrates on the "
                         "first 16 eval images)")
    ap.add_argument("--no-plot", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..api import Yolov4
    from ..config import YoloConfig
    from ..device import resolve_device

    device = resolve_device(args.device)
    cfg = YoloConfig(
        img_size=(args.img_size, args.img_size, 3),
        compute_dtype="bfloat16" if args.bf16 else "float32",
        letterbox=args.letterbox)
    model = Yolov4(weight_path=args.weights, class_name_path=args.classes,
                   config=cfg, device=device)

    if args.int8:
        import cv2
        import numpy as np
        with open(args.anno) as f:
            first = [l.split()[0] for l in f.read().splitlines() if l][:16]
        calib = np.stack([
            model.preprocess_img(cv2.cvtColor(
                cv2.imread(os.path.join(args.imgdir, p)), cv2.COLOR_BGR2RGB))
            for p in first]).astype(np.float32)
        model.quantize(calib_imgs=calib)

    gt = os.path.join(args.outdir, "ground_truth")
    pred = os.path.join(args.outdir, "pred_result")
    tmp_json = os.path.join(args.outdir, "json")
    result = os.path.join(args.outdir, "result")

    model.export_gt(args.anno, gt)
    model.export_prediction(args.anno, pred, args.imgdir, bs=args.bs)
    scores = model.eval_map(gt, pred, tmp_json, result,
                            plot=not args.no_plot)
    # eval_map returns {"mAP": x, "<class>": ap, ...}
    print(json.dumps({"mAP": scores["mAP"],
                      "per_class": {k: v for k, v in scores.items()
                                    if k != "mAP"}}))
    return scores


if __name__ == "__main__":
    main()
