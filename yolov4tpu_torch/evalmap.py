"""VOC-style mAP@0.5 evaluation pipeline: a copy of ``yolov4tpu.evalmap``
whose ``export_prediction`` feeds the port's ``predict_batch``.

File-format compatible with the reference's Cartucho/mAP-derived pipeline
(reference models.py:129-507, utils.py:311-467) so third-party tooling keeps
working:

  - GT txts:   ``<class> <x1> <y1> <x2> <y2>`` per object, one file per image
  - pred txts: ``<class> <conf> <x1> <y1> <x2> <y2>``
  - temp JSON: per-image ``*_ground_truth.json`` + per-class ``*_dr.json``
  - results:   ``output.txt`` byte-identical to the reference writer (header
    + final mAP; per-class APs are printed and returned, reference
    models.py:275,399,402), plus PNG plots

Matching semantics kept exactly: greedy assignment over detections sorted by
descending confidence, IoU with the +1-pixel convention (reference
models.py:303-310), min_overlap 0.5, used-flags so duplicate detections count
as false positives, and the VOC2012 monotone-envelope AP integration
(reference utils.py:311-356).

Plots are written headlessly (Agg) — the reference blocked on plt.show().
"""

from __future__ import annotations

import json
import os
from glob import glob
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .data.pipeline import letterbox_resize, letterbox_unmap
from .utils.io import read_txt_to_list
from .utils.stream import threaded_map

MIN_OVERLAP = 0.5  # reference models.py:315


def voc_ap(rec: List[float], prec: List[float]) -> Tuple[float, List[float], List[float]]:
    """VOC2012 AP: monotone precision envelope, area under PR curve
    (reference utils.py:311-356; mutates its list args the same way)."""
    rec.insert(0, 0.0)
    rec.append(1.0)
    mrec = rec[:]
    prec.insert(0, 0.0)
    prec.append(0.0)
    mpre = prec[:]
    for i in range(len(mpre) - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    ap = 0.0
    for i in range(1, len(mrec)):
        if mrec[i] != mrec[i - 1]:
            ap += (mrec[i] - mrec[i - 1]) * mpre[i]
    return ap, mrec, mpre


def _iou_plus1(bb: Sequence[float], bbgt: Sequence[float]) -> float:
    """IoU with the VOC +1-pixel convention (reference models.py:303-310)."""
    xi1, yi1 = max(bb[0], bbgt[0]), max(bb[1], bbgt[1])
    xi2, yi2 = min(bb[2], bbgt[2]), min(bb[3], bbgt[3])
    iw, ih = xi2 - xi1 + 1, yi2 - yi1 + 1
    if iw <= 0 or ih <= 0:
        return -1.0
    ua = ((bb[2] - bb[0] + 1) * (bb[3] - bb[1] + 1)
          + (bbgt[2] - bbgt[0] + 1) * (bbgt[3] - bbgt[1] + 1) - iw * ih)
    return iw * ih / ua


def export_gt(annotation_path: str, gt_folder_path: str,
              class_names: Sequence[str]) -> None:
    """Annotation txt -> per-image GT txt files (reference models.py:129-139)."""
    os.makedirs(gt_folder_path, exist_ok=True)
    with open(annotation_path) as file:
        for line in file:
            parts = line.split(" ")
            filename = os.path.basename(parts[0]).rsplit(".", 1)[0]
            with open(os.path.join(gt_folder_path, filename + ".txt"), "w") as out:
                for obj in parts[1:]:
                    x1, y1, x2, y2, cid = [float(v) for v in obj.strip().split(",")]
                    out.write(f"{class_names[int(cid)]} {x1} {y1} {x2} {y2}\n")


def export_prediction(predict_batch_fn: Callable, annotation_path: str,
                      pred_folder_path: str, img_folder_path: str,
                      target_img_size: Tuple[int, int],
                      class_names: Sequence[str], bs: int = 8,
                      verbose: bool = True, letterbox: bool = False,
                      transfer_uint8: bool = False,
                      place_fn: Optional[Callable] = None) -> None:
    """Run inference over all annotation images, write per-image pred txts
    (reference models.py:141-179) with boxes denormalised to original size.

    predict_batch_fn: (imgs (B,H,W,3) float32 in [0,1], or uint8) ->
        tensors (boxes_norm (B,T,4), scores (B,T), classes (B,T), valid (B,)).

    transfer_uint8: ship resized uint8 rasters instead of float32 (4x less
    host-to-device traffic; predict_batch divides by 255 on the device — the
    same raster the float path divides, since it resizes in uint8 before
    dividing).  Ignored under letterbox, whose gray-pad compositing is float.

    place_fn: optional device-placement callable applied to each image
    batch inside the producer thread (the ``Yolov4`` facade passes a
    pinned, non-blocking copy to its device), so batch N+1's copy overlaps
    batch N's inference.

    The last batch is not padded: the JAX package pads it only to keep its
    jitted shape static, and the port's predict_batch runs any batch size.
    """
    import cv2

    os.makedirs(pred_folder_path, exist_ok=True)
    with open(annotation_path) as file:
        img_paths = [os.path.join(img_folder_path, os.path.basename(l.split(" ")[0]))
                     for l in file if l.strip()]

    h, w = target_img_size
    u8_wire = transfer_uint8 and not letterbox

    def load_batch(paths):
        imgs = np.zeros((len(paths), h, w, 3),
                        np.uint8 if u8_wire else np.float32)
        raw_shapes = []
        transforms = []
        for j, path in enumerate(paths):
            img = cv2.imread(path)
            if img is None:
                raise FileNotFoundError(path)
            # BGR -> RGB, consistent with the training pipeline and the
            # predict()/predict_paths inference paths.  NOTE: the reference's
            # export_prediction skips this conversion (models.py:152-156 feed
            # cv2's BGR straight to preprocess_img) even though its predict()
            # converts — i.e. it evaluates a different input distribution
            # than it serves.  That inconsistency is a bug, not a behavior to
            # keep: mAP here measures the same pipeline predict() runs.
            img = img[:, :, ::-1]
            raw_shapes.append(img.shape)
            if letterbox:
                imgs[j], _, t = letterbox_resize(img, (h, w),
                                                 np.zeros((0, 5), np.float32))
                transforms.append(t)
            elif u8_wire:
                imgs[j] = cv2.resize(img, (w, h))
                transforms.append(None)
            else:
                imgs[j] = cv2.resize(img, (w, h)).astype(np.float32) / 255.0
                transforms.append(None)
        if place_fn is not None:
            imgs = place_fn(imgs)
        return paths, imgs, raw_shapes, transforms

    # Host decode runs in a producer thread two batches deep, so cv2
    # imread/resize of batch N+1 overlaps the (asynchronous) device
    # inference of batch N — the export becomes max(host, device) instead of
    # host + device per batch.
    batch_starts = range(0, len(img_paths), bs)
    batches = threaded_map(
        lambda start: load_batch(img_paths[start:start + bs]), batch_starts)

    progress = None
    if verbose:
        from tqdm import tqdm
        progress = tqdm(total=len(batch_starts))
    for paths, imgs, raw_shapes, transforms in batches:
        if progress is not None:
            progress.update(1)
        b_boxes, b_scores, b_classes, b_valid = [
            o.cpu().numpy() for o in predict_batch_fn(imgs)]

        for k, path in enumerate(paths):
            n = int(b_valid[k])
            boxes = b_boxes[k, :n].copy()
            rh, rw = raw_shapes[k][:2]
            if transforms[k] is not None:
                boxes = letterbox_unmap(boxes, transforms[k], (h, w),
                                        (rh, rw))
            else:
                boxes[:, [0, 2]] *= rw
                boxes[:, [1, 3]] *= rh
            names = [class_names[int(c)] for c in b_classes[k, :n]]
            filename = os.path.basename(path).rsplit(".", 1)[0]
            with open(os.path.join(pred_folder_path, filename + ".txt"), "w") as f:
                for i in range(n):
                    b = boxes[i]
                    f.write(f"{names[i]} {b_scores[k, i]} "
                            f"{b[0]} {b[1]} {b[2]} {b[3]}\n")
    if progress is not None:
        progress.close()


def eval_map(gt_folder_path: str, pred_folder_path: str,
             temp_json_folder_path: str, output_files_path: str,
             plot: bool = True, verbose: bool = True) -> Dict[str, float]:
    """Score predictions against GT; write output.txt (+ plots); return
    {'mAP': ..., per-class APs...} (reference models.py:182-507)."""
    for d in (temp_json_folder_path, output_files_path):
        os.makedirs(d, exist_ok=True)

    gt_files_list = sorted(glob(os.path.join(gt_folder_path, "*.txt")))
    assert len(gt_files_list) > 0, "no ground truth file"

    gt_counter_per_class: Dict[str, int] = {}
    counter_images_per_class: Dict[str, int] = {}

    # --- Phase 1: GT txts -> per-image JSON + class counters -------------
    for txt_file in gt_files_list:
        file_id = os.path.basename(txt_file)[:-len(".txt")]
        pred_path = os.path.join(pred_folder_path, file_id + ".txt")
        assert os.path.exists(pred_path), f"Error. File not found: {pred_path}"
        bounding_boxes = []
        seen_classes = set()
        for line in read_txt_to_list(txt_file):
            class_name, left, top, right, bottom = line.split()
            bounding_boxes.append({
                "class_name": class_name,
                "bbox": f"{left} {top} {right} {bottom}",
                "used": False,
            })
            gt_counter_per_class[class_name] = gt_counter_per_class.get(class_name, 0) + 1
            if class_name not in seen_classes:
                counter_images_per_class[class_name] = (
                    counter_images_per_class.get(class_name, 0) + 1)
                seen_classes.add(class_name)
        with open(os.path.join(temp_json_folder_path,
                               file_id + "_ground_truth.json"), "w") as f:
            json.dump(bounding_boxes, f)

    gt_classes = sorted(gt_counter_per_class.keys())
    n_classes = len(gt_classes)

    # --- Phase 2: pred txts -> per-class sorted JSON ---------------------
    dr_files_list = sorted(glob(os.path.join(pred_folder_path, "*.txt")))
    for class_name in gt_classes:
        bounding_boxes = []
        for txt_file in dr_files_list:
            file_id = os.path.basename(txt_file)[:-len(".txt")]
            for line in read_txt_to_list(txt_file):
                try:
                    name, confidence, left, top, right, bottom = line.split()
                except ValueError:
                    continue
                if name == class_name:
                    bounding_boxes.append({
                        "confidence": confidence, "file_id": file_id,
                        "bbox": f"{left} {top} {right} {bottom}"})
        bounding_boxes.sort(key=lambda x: float(x["confidence"]), reverse=True)
        with open(os.path.join(temp_json_folder_path, class_name + "_dr.json"),
                  "w") as f:
            json.dump(bounding_boxes, f)

    # --- Phase 3: per-class greedy matching + AP -------------------------
    sum_ap = 0.0
    ap_dictionary: Dict[str, float] = {}
    count_true_positives: Dict[str, int] = {}
    pr_curves = {}
    gt_cache = {}  # file_id -> gt list (avoids the reference's per-detection re-read)

    def gt_load(file_id):
        if file_id not in gt_cache:
            p = os.path.join(temp_json_folder_path, file_id + "_ground_truth.json")
            with open(p) as f:
                gt_cache[file_id] = json.load(f)
        return gt_cache[file_id]

    with open(os.path.join(output_files_path, "output.txt"), "w") as output_file:
        output_file.write("# AP and precision/recall per class\n")
        for class_name in gt_classes:
            count_true_positives[class_name] = 0
            with open(os.path.join(temp_json_folder_path,
                                   class_name + "_dr.json")) as f:
                dr_data = json.load(f)
            nd = len(dr_data)
            tp = [0] * nd
            fp = [0] * nd
            for idx, detection in enumerate(dr_data):
                ground_truth_data = gt_load(detection["file_id"])
                bb = [float(x) for x in detection["bbox"].split()]
                ovmax, gt_match = -1.0, None
                for obj in ground_truth_data:
                    if obj["class_name"] == class_name:
                        bbgt = [float(x) for x in obj["bbox"].split()]
                        ov = _iou_plus1(bb, bbgt)
                        if ov > ovmax:
                            ovmax, gt_match = ov, obj
                if ovmax >= MIN_OVERLAP and gt_match is not None:
                    if not gt_match["used"]:
                        tp[idx] = 1
                        gt_match["used"] = True
                        count_true_positives[class_name] += 1
                    else:
                        fp[idx] = 1  # duplicate detection
                else:
                    fp[idx] = 1

            # cumulative sums -> precision/recall
            for i in range(1, nd):
                fp[i] += fp[i - 1]
                tp[i] += tp[i - 1]
            rec = [t / gt_counter_per_class[class_name] for t in tp]
            prec = [t / (f + t) if (f + t) > 0 else 0.0
                    for f, t in zip(fp, tp)]

            ap, mrec, mpre = voc_ap(rec[:], prec[:])
            sum_ap += ap
            ap_dictionary[class_name] = ap
            pr_curves[class_name] = (rec, prec, mrec, mpre)
            text = "{0:.2f}%".format(ap * 100) + " = " + class_name + " AP "
            # The reference only PRINTS the per-class AP line; output.txt
            # gets just the header and the final mAP (the only
            # output_file.write calls are reference models.py:275,399,402).
            # Byte-equality with the JAX package's writer is pinned by
            # tests/test_torch_evalmap.py.
            if verbose:
                print(text)

        mAP = sum_ap / n_classes if n_classes else 0.0
        output_file.write("\n# mAP of all classes\n")
        text = "mAP = {0:.2f}%".format(mAP * 100)
        output_file.write(text + "\n")
        if verbose:
            print(text)

    # Persist used-flag updates like the reference does (models.py:324-325).
    for file_id, data in gt_cache.items():
        with open(os.path.join(temp_json_folder_path,
                               file_id + "_ground_truth.json"), "w") as f:
            f.write(json.dumps(data))

    # --- Phase 4: detection counters + plots -----------------------------
    det_counter_per_class: Dict[str, int] = {}
    for txt_file in dr_files_list:
        for line in read_txt_to_list(txt_file):
            name = line.split()[0]
            det_counter_per_class[name] = det_counter_per_class.get(name, 0) + 1
    for class_name in det_counter_per_class:
        if class_name not in gt_classes:
            count_true_positives[class_name] = 0

    if plot:
        _write_plots(output_files_path, gt_counter_per_class,
                     counter_images_per_class, det_counter_per_class,
                     count_true_positives, ap_dictionary, pr_curves,
                     len(gt_files_list), len(dr_files_list), mAP)

    return {"mAP": mAP, **ap_dictionary}


def _write_plots(output_files_path, gt_counter_per_class,
                 counter_images_per_class, det_counter_per_class,
                 count_true_positives, ap_dictionary, pr_curves,
                 n_gt_files, n_dr_files, mAP):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n_classes = len(gt_counter_per_class)

    # Per-class PR curves (reference shows interactively, models.py:368-394;
    # here they are saved under classes/).
    classes_dir = os.path.join(output_files_path, "classes")
    os.makedirs(classes_dir, exist_ok=True)
    for class_name, (rec, prec, mrec, mpre) in pr_curves.items():
        plt.figure()
        plt.plot(rec, prec, "-o")
        area_x = mrec[:-1] + [mrec[-2]] + [mrec[-1]]
        area_y = mpre[:-1] + [0.0] + [mpre[-1]]
        plt.fill_between(area_x, 0, area_y, alpha=0.2, edgecolor="r")
        plt.title(f"class: {ap_dictionary[class_name]*100:.2f}% = {class_name} AP")
        plt.xlabel("Recall")
        plt.ylabel("Precision")
        plt.gca().set_xlim([0.0, 1.0])
        plt.gca().set_ylim([0.0, 1.05])
        plt.savefig(os.path.join(classes_dir, class_name + ".png"))
        plt.close()

    def barh(dictionary, title, xlabel, path, true_p_bar=None):
        plt.figure()
        items = sorted(dictionary.items(), key=lambda kv: kv[1])
        keys = [k for k, _ in items]
        vals = [v for _, v in items]
        if true_p_bar is not None:
            fp_vals = [dictionary[k] - true_p_bar.get(k, 0) for k in keys]
            tp_vals = [true_p_bar.get(k, 0) for k in keys]
            plt.barh(range(len(keys)), fp_vals, color="crimson",
                     label="False Positive")
            plt.barh(range(len(keys)), tp_vals, left=fp_vals,
                     color="forestgreen", label="True Positive")
            plt.legend(loc="lower right")
        else:
            plt.barh(range(len(keys)), vals, color="forestgreen")
        plt.yticks(range(len(keys)), keys, fontsize=12)
        plt.title(title, fontsize=14)
        plt.xlabel(xlabel, fontsize="large")
        plt.tight_layout()
        plt.savefig(path)
        plt.close()

    barh(gt_counter_per_class,
         f"ground-truth\n({n_gt_files} files and {n_classes} classes)",
         "Number of objects per class",
         os.path.join(output_files_path, "ground-truth-info.png"))
    if det_counter_per_class:
        n_det_classes = sum(int(v) > 0 for v in det_counter_per_class.values())
        barh(det_counter_per_class,
             f"detection-results\n({n_dr_files} files and {n_det_classes} detected classes)",
             "Number of objects per class",
             os.path.join(output_files_path, "detection-results-info.png"),
             true_p_bar=count_true_positives)
    barh(ap_dictionary, "mAP = {0:.2f}%".format(mAP * 100),
         "Average Precision", os.path.join(output_files_path, "mAP.png"))
