"""Detection post-processing to DataFrame + drawing (reference utils.py:56-118).

A copy of ``yolov4tpu.utils.visualize``.
"""

from __future__ import annotations

import numpy as np
import pandas as pd


def get_detection_data(img, model_outputs, class_names,
                       letterbox_transform=None):
    """Model NMS outputs -> pandas DataFrame (reference utils.py:56-78).

    model_outputs: (boxes, scores, classes, valid_detections) batched numpy
    arrays; entry 0 of the batch is used.  Boxes are normalised [0,1]; they
    are scaled to the raw image's size.  Columns: [x1, y1, x2, y2,
    class_name, score, w, h], as in the reference.

    letterbox_transform: ((scale, dx, dy), (model_h, model_w)) when the image
    was letterboxed: boxes are then unpadded and unscaled back to raw
    coordinates instead of plain stretching.
    """
    num_bboxes = int(np.asarray(model_outputs[-1])[0])
    boxes, scores, classes = [np.asarray(o)[0][:num_bboxes]
                              for o in model_outputs[:-1]]
    h, w = img.shape[:2]
    if letterbox_transform is not None:
        from ..data.pipeline import letterbox_unmap
        transform, model_hw = letterbox_transform
        boxes = letterbox_unmap(boxes, transform, model_hw, (h, w))
        df = pd.DataFrame(boxes.astype("int64"),
                          columns=["x1", "y1", "x2", "y2"])
    else:
        df = pd.DataFrame(boxes, columns=["x1", "y1", "x2", "y2"])
        df[["x1", "x2"]] = (df[["x1", "x2"]] * w).astype("int64")
        df[["y1", "y2"]] = (df[["y1", "y2"]] * h).astype("int64")
    df["class_name"] = np.array(class_names)[classes.astype("int64")]
    df["score"] = scores
    df["w"] = df["x2"] - df["x1"]
    df["h"] = df["y2"] - df["y1"]
    return df


def draw_bbox(img, detections, cmap, random_color=True, figsize=(10, 10),
              show_img=True, show_text=True, rng=None):
    """Annotate an image with detection rectangles and score labels.

    Outline thickness tracks image size relative to the 416 operating point;
    each label sits in a class-colored fill above the box's top-left corner
    with white text.  ``cmap`` maps class name -> color triple;
    ``random_color=True`` draws a fresh color per box from ``rng`` (a
    ``np.random.Generator``; a fresh unseeded one if omitted).  Returns the
    annotated array; the input is never mutated.
    """
    import cv2

    canvas = np.ascontiguousarray(np.array(img))
    rel = max(canvas.shape[:2]) / 416.0
    box_px = max(int(2 * rel), 1)
    font, font_scale = cv2.FONT_HERSHEY_DUPLEX, max(0.3 * rel, 0.3)
    text_px = max(int(rel), 1)
    if random_color and rng is None:
        rng = np.random.default_rng()

    corners = detections[["x1", "y1", "x2", "y2"]].to_numpy().astype(int)
    labels = [f"{name} {conf:.2f}" for name, conf in
              zip(detections["class_name"], detections["score"])]
    for (x1, y1, x2, y2), label, name in zip(corners, labels,
                                             detections["class_name"]):
        color = (tuple(rng.uniform(0, 255, 3)) if random_color
                 else tuple(cmap[name]))
        cv2.rectangle(canvas, (x1, y1), (x2, y2), color, box_px)
        if show_text:
            (tw, th), _ = cv2.getTextSize(label, font, fontScale=font_scale,
                                          thickness=text_px)
            cv2.rectangle(canvas, (x1 - box_px // 2, y1 - th), (x1 + tw, y1),
                          color, cv2.FILLED)
            cv2.putText(canvas, label, (x1, y1), font, font_scale,
                        (255, 255, 255), text_px, cv2.LINE_AA)
    if show_img:
        import matplotlib.pyplot as plt
        plt.figure(figsize=figsize)
        plt.imshow(canvas)
        plt.show()
    return canvas
