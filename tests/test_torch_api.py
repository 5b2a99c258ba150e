"""The whole slice: the port's ``Yolov4`` facade on the CPU against the JAX
package's ``Yolov4``, on the same weights and images — seeded init,
BN-folded forward, fused decode, candidate NMS, the DataFrame surface.

Contract (the one the JAX package holds to the tf.keras reference): boxes
and scores within 1e-3 per detection, classes and valid counts equal.  The
params are well-conditioned and density-calibrated (tens of boxes per
image clear the 0.3 threshold, none near it), so ~1e-7 differences between
the two conv libraries cannot flip a detection.
"""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, assert_detections_equal, calibrated,
                           images, to_numpy)
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_from_jax

NUM_CLASSES = 3


@pytest.fixture(scope="module")
def models(tiny_classes):
    """(JAX Yolov4, port Yolov4 on the CPU) on the same calibrated weights,
    and the (params, state) each drew at construction (seed 0)."""
    params, state, _ = calibrated(NUM_CLASSES)
    kw = dict(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)
    jm = japi.Yolov4(None, tiny_classes, config=JaxConfig(**kw))
    tm = tapi.Yolov4(None, tiny_classes, config=YoloConfig(**kw),
                     device="cpu")
    inits = (jm.params, jm.state), (tm.params, tm.state)
    jm.sync_params(params, state)
    tm.sync_params(*params_from_jax(params, state))
    return jm, tm, inits


def test_seeded_init_matches_jax(models):
    """network.init draws the same numpy stream as the JAX package's."""
    (jp, js), (tp, ts) = models[2]
    assert len(tp["convs"]) == len(jp["convs"])
    for g, w in zip(tp["convs"], jp["convs"]):
        assert set(g) == set(w)
        np.testing.assert_array_equal(
            g["w"].numpy(), np.asarray(w["w"]).transpose(3, 2, 0, 1))
        for key in set(w) - {"w"}:
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    for g, w in zip(ts["bn"], js["bn"]):
        assert (g is None) == (w is None)
        if w is not None:
            for key in w:
                np.testing.assert_array_equal(g[key].numpy(),
                                              np.asarray(w[key]))


def _batch_u8():
    # The two calibration images, and one more (a ragged batch of 3, which
    # the JAX package pads to 4 and the port runs as it is).
    return np.concatenate([images(0, 2), images(7, 1)])


@pytest.mark.parametrize("wire", ["float", "uint8"])
def test_predict_batch_matches_jax(models, wire):
    jm, tm, _ = models
    imgs = _batch_u8()
    if wire == "float":
        imgs = imgs.astype(np.float32) / 255.0
    want = jm.predict_batch(imgs)
    got = tm.predict_batch(imgs)
    assert all(o.device.type == "cpu" for o in got)
    assert tuple(got[0].shape) == (3, 100, 4)
    assert to_numpy(want[3])[:2].min() >= 5   # detections survive NMS
    assert_detections_equal(got, want, box_atol=1e-3, score_atol=1e-3)
    if wire == "uint8":
        # The uint8 wire divides on the device: the same detections.
        for a, b in zip(got, tm.predict_batch(imgs.astype(np.float32) / 255)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_xla_nms_impl_matches_jax(models):
    """build_infer_fn with nms_impl="xla": decode_head ->
    flatten_boxes_scores -> exact combined NMS, in both packages."""
    jm, tm, _ = models
    imgs = _batch_u8().astype(np.float32) / 255.0
    want = japi.build_infer_fn(jm.config.replace(nms_impl="xla"), NUM_CLASSES,
                               jnp.float32)(jm._folded, imgs, iou_t=0.413,
                                            score_t=0.3)
    got = tapi.build_infer_fn(tm.config.replace(nms_impl="xla"), NUM_CLASSES,
                              torch.float32)(tm._folded, torch.from_numpy(imgs),
                                             0.413, 0.3)
    assert to_numpy(want[3])[:2].min() >= 5
    assert_detections_equal(got, want, box_atol=1e-3, score_atol=1e-3)
    # <= K boxes clear the threshold, so the fast path agrees with it.
    assert_detections_equal(tm.predict_batch(imgs), got, box_atol=1e-6,
                            score_atol=1e-6)


def test_predict_on_jpeg_matches_jax(models, tmp_path):
    import cv2
    jm, tm, _ = models
    raw = cv2.resize(images(0, 1)[0], (96, 80))
    path = str(tmp_path / "scene.jpg")
    cv2.imwrite(path, raw[:, :, ::-1])
    want = jm.predict(path, plot_img=False)
    got = tm.predict(path, plot_img=False)
    assert list(got.columns) == ["x1", "y1", "x2", "y2", "class_name",
                                 "score", "w", "h"]
    assert len(got) == len(want) > 0
    assert list(got["class_name"]) == list(want["class_name"])
    # Pixel corners are int-truncated from normalised boxes within 1e-3.
    cols = ["x1", "y1", "x2", "y2"]
    assert np.abs(got[cols].to_numpy() - want[cols].to_numpy()).max() <= 1
    np.testing.assert_allclose(got["score"], want["score"], atol=1e-3)

    # predict_raw and predict_nonms feed cv2's BGR order, as the reference.
    bgr = torch.from_numpy(tm.preprocess_img(cv2.imread(path))[None]).float()
    for g, w in zip(tm.predict_raw(path), tm._raw(bgr)):
        np.testing.assert_array_equal(g, w.numpy())
    nonms = tm.predict_nonms(path, 0.5, 0.2)
    out = tm.predict_batch(bgr, 0.5, 0.2)
    assert len(nonms) == int(out[3][0])
    np.testing.assert_allclose(nonms["score"], out[1][0, :len(nonms)].numpy())


def test_unported_options_raise(models, tiny_classes, tmp_path):
    tm = copy.copy(models[1])
    # nms_impl="pallas" and letterbox are ported; an unknown NMS still raises.
    with pytest.raises(ValueError, match="unknown nms_impl"):
        tapi.build_infer_fn(tm.config.replace(nms_impl="tf"), 3,
                            torch.float32)
    # int8 quantization is ported: quantize() switches the copy to int8.
    assert tm.quantize(calib_imgs=images(0, 1) / 255.0) is tm
    assert any("wq" in p for p in tm._folded["convs"])
    assert not any("wq" in p for p in models[1]._folded["convs"])
    unknown = tmp_path / "model.bin"
    unknown.write_bytes(b"")
    with pytest.raises(ValueError, match="unsupported weight file"):
        tapi.Yolov4(str(unknown), tiny_classes, device="cpu")
    # An .npz checkpoint of the full network loads as the weights.
    from yolov4tpu_torch.checkpoint import save_npz
    from yolov4tpu_torch.models.network import init, params_to_jax
    params, state, _ = init(3, IMG, seed=2)
    npz = tmp_path / "full.npz"
    save_npz(str(npz), *params_to_jax(params, state))
    loaded = tapi.Yolov4(str(npz), tiny_classes, device="cpu",
                         config=YoloConfig(img_size=(IMG, IMG, 3)))
    for a, b in zip(loaded.params["convs"], params["convs"]):
        for k in b:
            assert torch.equal(a[k], b[k])
