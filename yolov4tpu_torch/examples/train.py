"""Train or fine-tune YOLOv4 on an annotated image set (the train
notebook's journey) as a command line.

Usage::

    python -m yolov4tpu_torch.examples.train --anno anno.txt \
        --classes classes.txt --imgdir imgs/ [--val-anno anno-val.txt] \
        [--epochs 100] [--bf16] [--mosaic] [--ckpt ckpts/] [--device cuda]

    # data parallel over N cards of one host: one process per card
    torchrun --nproc_per_node N -m yolov4tpu_torch.examples.train \
        --devices N ...

The model is YOLOv4 at full depth; ``--weights`` initialises it from a
darknet ``.weights`` file or an ``.npz`` checkpoint, else from a seeded
random init.  The data generators are seeded (0), so every rank of a
data-parallel run draws the same batches and a run can be repeated.
Checkpoints go to ``CKPT/epoch{epoch}.npz`` after each epoch (counted from
0), and the final weights to ``--out``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None):
    """The command line (``argv``: its arguments, default ``sys.argv``);
    returns the trained facade."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--anno", required=True)
    ap.add_argument("--val-anno", default=None)
    ap.add_argument("--classes", required=True)
    ap.add_argument("--imgdir", required=True)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="per-device batch")
    ap.add_argument("--devices", type=int, default=1,
                    help="data-parallel ranks, one process per card: start "
                         "the script with torchrun --nproc_per_node N; "
                         "without a process group of N ranks it raises")
    ap.add_argument("--weights", default=None,
                    help="init from darknet .weights / .npz (else random)")
    ap.add_argument("--bf16", action="store_true")
    ap.add_argument("--mosaic", action="store_true")
    ap.add_argument("--hflip", action="store_true")
    ap.add_argument("--jitter", action="store_true", help="HSV color jitter")
    ap.add_argument("--letterbox", action="store_true")
    ap.add_argument("--multi-scale", nargs=2, type=int, default=None,
                    metavar=("LO", "HI"),
                    help="random square train size in [LO, HI] step 32")
    ap.add_argument("--accum", type=int, default=1,
                    help="gradient accumulation micro-steps")
    ap.add_argument("--smooth", type=float, default=0.0)
    ap.add_argument("--encode-on-device", action="store_true",
                    help="scatter the label grids on the device inside the "
                         "step (the host ships raw box tables)")
    ap.add_argument("--no-bn-stats-grad", action="store_true",
                    help="stop gradients through BN batch statistics "
                         "(not the reference's BN math)")
    ap.add_argument("--pallas-wgrad", action="store_true",
                    help="the hand-written CUDA 3x3 weight-gradient kernel "
                         "in the backward (ops/wgrad_cuda.py)")
    ap.add_argument("--ckpt", default=None, help="checkpoint dir")
    ap.add_argument("--out", default="final.npz",
                    help="final checkpoint path")
    ap.add_argument("--img-size", type=int, default=416,
                    help="square input size (any /32-divisible value)")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..api import Yolov4
    from ..callbacks import CheckpointCallback
    from ..config import YoloConfig
    from ..data.pipeline import DataGenerator
    from ..device import resolve_device
    from ..parallel.mesh import init_distributed, on_rank0
    from ..utils.io import read_annotation_lines

    device = resolve_device(args.device)
    if args.devices > 1:
        init_distributed()

    cfg = YoloConfig(img_size=(args.img_size, args.img_size, 3),
                     batch_size=args.batch, num_devices=args.devices,
                     compute_dtype="bfloat16" if args.bf16 else "float32",
                     use_mosaic=args.mosaic, label_smoothing=args.smooth,
                     use_hflip=args.hflip, use_color_jitter=args.jitter,
                     letterbox=args.letterbox,
                     multi_scale=(tuple(args.multi_scale)
                                  if args.multi_scale else None),
                     grad_accum_steps=args.accum,
                     encode_on_device=args.encode_on_device,
                     bn_stats_gradient=not args.no_bn_stats_grad,
                     pallas_wgrad=args.pallas_wgrad)

    train_lines = read_annotation_lines(args.anno)
    val_lines = (read_annotation_lines(args.val_anno)
                 if args.val_anno else None)
    train_gen = DataGenerator(train_lines, args.classes, args.imgdir,
                              config=cfg, seed=0)
    val_gen = (DataGenerator(val_lines, args.classes, args.imgdir, config=cfg,
                             shuffle=False, seed=0) if val_lines else None)

    model = Yolov4(weight_path=args.weights, class_name_path=args.classes,
                   config=cfg, device=device)
    callbacks = []
    if args.ckpt:
        callbacks.append(CheckpointCallback(args.ckpt + "/epoch{epoch}.npz"))
    model.fit(train_gen, epochs=args.epochs, val_data_gen=val_gen,
              callbacks=callbacks)
    on_rank0(model.trainer().mesh, lambda: model.save_model(args.out))
    return model


if __name__ == "__main__":
    main()
