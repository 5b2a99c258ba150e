"""The dataset-evaluation slice as a whole: the port's ``Yolov4`` on the CPU
with ``nms_impl="pallas"`` (per-class top-K + the sorted suppression
kernel's plain version) against the JAX package's ``Yolov4`` with the same
option (Pallas in interpret mode), on the same weights and JPEGs:
``predict_batch``, streaming ``predict_paths`` with letterbox and with the
uint8 wire, and ``export_gt`` -> ``export_prediction`` -> ``eval_map``.

Contract (the one the JAX package holds to the tf.keras reference): boxes
and scores within 1e-3 per detection, classes and counts equal, and so the
same mAP.  The params are density-calibrated, so ~1e-7 differences between
the two conv libraries cannot flip a detection.  Every JAX call runs batch 4
in float32 or uint8: two XLA compiles for the file.
"""

import copy

import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, assert_detections_equal, calibrated,
                           images)
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_from_jax

NUM_CLASSES = 3
BS = 4
# Raw JPEG sizes (h, w): wide, tall, square and odd, so letterbox pads both
# ways; six images make one full batch of 4 and a ragged batch of 2.
SIZES = [(80, 96), (120, 64), (64, 64), (96, 150), (150, 100), (77, 91)]


@pytest.fixture(scope="module")
def models(tiny_classes):
    """(JAX Yolov4, port Yolov4 on the CPU), both nms_impl="pallas", on the
    same calibrated weights."""
    params, state, _ = calibrated(NUM_CLASSES)
    kw = dict(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW, nms_impl="pallas")
    jm = japi.Yolov4(None, tiny_classes, config=JaxConfig(**kw))
    tm = tapi.Yolov4(None, tiny_classes, config=YoloConfig(**kw),
                     device="cpu")
    jm.sync_params(params, state)
    tm.sync_params(*params_from_jax(params, state))
    return jm, tm


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    import cv2
    folder = tmp_path_factory.mktemp("jpegs")
    paths = []
    for i, (h, w) in enumerate(SIZES):
        path = folder / f"scene{i}.jpg"
        cv2.imwrite(str(path), cv2.resize(images(i % 2, 1)[0], (w, h)))
        paths.append(str(path))
    return paths


def _with(model, **changes):
    """A shallow copy of a facade with config fields changed; it shares the
    compiled inference function."""
    model = copy.copy(model)
    model.config = model.config.replace(**changes)
    return model


def test_predict_batch_matches_jax_and_exact_nms(models):
    jm, tm = models
    imgs = np.concatenate([images(0, 2), images(7, 2)]).astype(np.float32)
    imgs /= 255.0
    want = jm.predict_batch(imgs)
    got = tm.predict_batch(imgs)
    assert np.asarray(want[3]).min() >= 5
    assert_detections_equal(got, want, box_atol=1e-3, score_atol=1e-3)
    # In the port the sorted path equals the plain exact NMS, also at the
    # mAP convention's score threshold, where all 252 boxes are candidates.
    xla = tapi.build_infer_fn(tm.config.replace(nms_impl="xla"), NUM_CLASSES,
                              torch.float32)
    for score_t in (0.3, 0.05):
        sorted_out = tm.predict_batch(imgs, score_threshold=score_t)
        exact = xla(tm._folded, torch.from_numpy(imgs), 0.413, score_t)
        assert_detections_equal(sorted_out, exact, box_atol=0, score_atol=0)


def _assert_frames_match(got, want):
    assert len(got) == len(want)
    assert list(got["class_name"]) == list(want["class_name"])
    cols = ["x1", "y1", "x2", "y2"]
    # Pixel corners are int-truncated from boxes within 1e-3 of each other.
    assert np.abs(got[cols].to_numpy() - want[cols].to_numpy()).max() <= 1
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-3)


@pytest.mark.parametrize("wire", [{"letterbox": True},
                                  {"transfer_uint8": True}],
                         ids=["letterbox", "uint8"])
def test_predict_paths_matches_jax(models, jpegs, wire):
    jm, tm = (_with(m, **wire) for m in models)
    got = list(tm.predict_paths(jpegs, bs=BS))
    want = list(jm.predict_paths(jpegs, bs=BS))
    assert [p for p, _ in got] == [p for p, _ in want] == jpegs
    assert sum(len(df) for _, df in want) >= 10
    for (_, g), (_, w) in zip(got, want):
        _assert_frames_match(g, w)


def _read_preds(folder, name):
    rows = [line.split() for line in (folder / name).read_text().splitlines()]
    return ([r[0] for r in rows], np.array([[float(v) for v in r[1:]]
                                            for r in rows]).reshape(-1, 5))


@pytest.mark.parametrize("wire", [{}, {"letterbox": True},
                                  {"transfer_uint8": True}],
                         ids=["float", "letterbox", "uint8"])
def test_export_and_eval_map_match_jax(models, jpegs, wire, tmp_path):
    jm, tm = (_with(m, **wire) for m in models)
    # Ground truth: half of each image's JAX detections (rounded to pixels)
    # and one box the model does not find, so the mAP is neither 0 nor 1.
    lines = []
    for path, df in jm.predict_paths(jpegs, bs=BS):
        boxes = [f"{int(r.x1)},{int(r.y1)},{int(r.x2)},{int(r.y2)},"
                 f"{jm.class_names.index(r.class_name)}"
                 for r in df.iloc[::2].itertuples()]
        boxes.append("1,2,30,40,1")
        lines.append(path.rsplit("/", 1)[1] + " " + " ".join(boxes) + "\n")
    anno = tmp_path / "anno.txt"
    anno.write_text("".join(lines))
    folder = jpegs[0].rsplit("/", 1)[0]
    maps = {}
    for name, m in (("port", tm), ("jax", jm)):
        d = {k: str(tmp_path / name / k) for k in ("gt", "pred", "json", "out")}
        m.export_gt(str(anno), d["gt"])
        m.export_prediction(str(anno), d["pred"], folder, bs=BS, verbose=False)
        maps[name] = m.eval_map(d["gt"], d["pred"], d["json"], d["out"],
                                plot=False, verbose=False)
    port, jax = tmp_path / "port" / "pred", tmp_path / "jax" / "pred"
    for i, (h, w) in enumerate(SIZES):
        names, got = _read_preds(port, f"scene{i}.txt")
        want_names, want = _read_preds(jax, f"scene{i}.txt")
        assert names == want_names and len(names) > 0
        np.testing.assert_allclose(got[:, 0], want[:, 0], atol=1e-3)
        size = np.array([w, h, w, h])
        assert (np.abs(got[:, 1:] - want[:, 1:]) <= 1e-3 * size).all()
    assert maps["port"] == maps["jax"]
    assert 0 < maps["port"]["mAP"] < 1
    assert ((tmp_path / "port" / "out" / "output.txt").read_bytes()
            == (tmp_path / "jax" / "out" / "output.txt").read_bytes())
