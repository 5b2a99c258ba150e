"""Video inference: annotate a video file (or stream) with detections, the
counterpart of ``yolov4tpu.tools.video``.

Frames are decoded and batched in a producer thread (``threaded_map``),
run through ``predict_batch`` on the card, and drawn back at their own
resolution: the host/device overlap of ``Yolov4.predict_paths``.  The
output is written with the ``mp4v`` codec; a writer that cannot be opened
raises.  On a facade sharded over several ranks (``Yolov4.distribute``)
every rank reads the input and runs its rows, and rank 0 alone draws and
writes the output.

Usage (CLI)::

    python -m yolov4tpu_torch.tools.video --weights yolov4.weights \
        --classes class_names/coco_classes.txt \
        --input in.mp4 --output out.mp4 [--bs 8] [--score 0.5] \
        [--device cuda]
"""

from __future__ import annotations

from typing import Optional, Sequence


def annotate_video(model, input_path: str, output_path: str, bs: int = 8,
                   score_threshold: Optional[float] = None,
                   max_frames: Optional[int] = None,
                   verbose: bool = True) -> int:
    """Run detection over every frame of ``input_path`` and write an
    annotated video to ``output_path``.  Returns the frame count."""
    import cv2
    import numpy as np

    from ..parallel.mesh import barrier
    from ..utils.stream import threaded_map
    from ..utils.visualize import draw_bbox, get_detection_data

    mesh = getattr(model, "_mesh", None)
    writes = mesh is None or mesh.rank == 0
    cap = cv2.VideoCapture(input_path)
    if not cap.isOpened():
        raise FileNotFoundError(input_path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 25.0
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = None
    if writes:
        writer = cv2.VideoWriter(output_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps, (w, h))
        if not writer.isOpened():
            cap.release()
            raise RuntimeError(f"cv2 cannot write {output_path} with the "
                               "mp4v codec")

    def read_batches():
        done = False
        count = 0
        while not done:
            raws = []
            while len(raws) < bs:
                if max_frames is not None and count >= max_frames:
                    done = True
                    break
                ok, frame = cap.read()
                if not ok:
                    done = True
                    break
                raws.append(frame[:, :, ::-1])  # BGR -> RGB
                count += 1
            if raws:
                yield raws

    def preprocess(raws):
        # Wire format (uint8 vs float) and placement are the facade's
        # streaming loader's (Yolov4._batch_from_rgb).
        imgs, transforms = model._batch_from_rgb(raws)
        return raws, imgs, transforms

    n = 0
    try:
        for raws, imgs, transforms in threaded_map(preprocess,
                                                   read_batches()):
            outs = [o.cpu().numpy() for o in model.predict_batch(
                imgs, score_threshold=score_threshold)]
            n += len(raws)
            if writer is None:
                continue
            for k, raw in enumerate(raws):
                row = [o[k:k + 1] for o in outs]
                df = get_detection_data(img=raw, model_outputs=row,
                                        class_names=model.class_names,
                                        letterbox_transform=transforms[k])
                frame = draw_bbox(np.ascontiguousarray(raw), df,
                                  cmap=model.class_color, random_color=False,
                                  show_img=False, show_text=True)
                writer.write(np.asarray(frame)[:, :, ::-1].astype(np.uint8))
            if verbose and n % (bs * 10) == 0:
                print(f"{n} frames", flush=True)
    finally:
        cap.release()
        if writer is not None:
            writer.release()
    if mesh is not None:
        barrier(mesh)
    if verbose and writes:
        print(f"wrote {n} annotated frames to {output_path}")
    return n


def main(argv: Optional[Sequence[str]] = None) -> int:
    """The command line (``argv``: its arguments, default ``sys.argv``);
    returns the frame count."""
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--weights", required=True)
    ap.add_argument("--classes", required=True)
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", required=True)
    ap.add_argument("--bs", type=int, default=8)
    ap.add_argument("--score", type=float, default=None)
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..api import Yolov4
    from ..config import YoloConfig

    model = Yolov4(weight_path=args.weights, class_name_path=args.classes,
                   config=YoloConfig(compute_dtype="bfloat16"),
                   device=args.device)
    return annotate_video(model, args.input, args.output, bs=args.bs,
                          score_threshold=args.score,
                          max_frames=args.max_frames)


if __name__ == "__main__":
    main()
