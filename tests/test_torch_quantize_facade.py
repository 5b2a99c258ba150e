"""The port's ``Yolov4.quantize`` / ``dequantize`` on the CPU: the JAX
signatures, the int8 switch and its way back, calibration from files,
requantization on new weights with the kept scales, float weights in
``save_model``, and the uint8 wire.
"""

import inspect

import numpy as np
import pytest
import torch

from _torch_parity import IMG, SHALLOW, images, rel_rms, torch_params
from yolov4tpu import api as japi
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.checkpoint import load_npz
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models import network, quantize as tq

C = 3


@pytest.fixture(scope="module")
def built(tiny_classes):
    m = tapi.Yolov4(None, tiny_classes, device="cpu",
                    config=YoloConfig(img_size=(IMG, IMG, 3),
                                      csp_repeats=SHALLOW, nms_pre_top_k=64,
                                      score_threshold=0.05))
    m.sync_params(*torch_params(C))
    return m


@pytest.fixture
def facade(built):
    """The module's facade, returned to float and its weights after each
    test."""
    yield built
    built.dequantize()
    built.sync_params(*torch_params(C))


def test_facade_signatures_match_jax():
    for name in ("quantize", "dequantize"):
        want = inspect.signature(getattr(japi.Yolov4, name)).parameters
        got = inspect.signature(getattr(tapi.Yolov4, name)).parameters
        assert list(got) == list(want)
        assert [p.default for p in got.values()] == \
            [p.default for p in want.values()]


def test_facade_quantize_dequantize_round_trip(facade):
    """quantize() switches predict_batch and predict_raw to int8 (the
    facade's scales are calibrate's on its own folded params), and
    dequantize() restores the float path bit for bit."""
    imgs = images(1, 2).astype(np.float32) / 255.0
    x = torch.from_numpy(imgs)
    ref = facade.predict_batch(imgs)
    ref_raw = facade._raw(x)
    assert facade.quantize(calib_imgs=imgs) is facade
    assert sum("wq" in p for p in facade._folded["convs"]) == 69
    want = tq.calibrate(network.fold_bn(facade.params, facade.state), imgs,
                        C, torch.float32, SHALLOW)
    for k in want:
        np.testing.assert_array_equal(facade._act_scales[k], want[k])
    q = facade.predict_batch(imgs)
    assert int(q[3].min()) > 0 and q[0].shape == ref[0].shape
    q_raw = facade._raw(x)
    for a, b in zip(q_raw, ref_raw):
        assert not torch.equal(a, b) and rel_rms(a, b) < 0.15
    assert facade.dequantize() is facade
    assert facade._act_scales is None
    for a, b in zip(facade.predict_batch(imgs), ref):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="'int8' or 'bf16'"):
        facade.quantize(calib_imgs=imgs, dataflow="int4")
    with pytest.raises(ValueError, match="needs calib_imgs"):
        facade.quantize()
    with pytest.raises(ValueError, match="'max' or 'percentile'"):
        facade.quantize(calib_imgs=imgs, calib_method="entropy")


def test_facade_calib_paths(facade, tmp_path):
    """calib_paths: the files run through preprocess_img (RGB), giving the
    scales of the same images passed as calib_imgs."""
    import cv2
    raws = images(2, 2, img=80)
    paths = []
    for i, raw in enumerate(raws):
        paths.append(str(tmp_path / f"{i}.png"))
        cv2.imwrite(paths[-1], raw[:, :, ::-1])
    facade.quantize(calib_paths=paths, calib_method="percentile")
    by_path = facade._act_scales
    pre = np.stack([facade.preprocess_img(r) for r in raws])
    facade.quantize(calib_imgs=pre, calib_method="percentile")
    for k in by_path:
        np.testing.assert_array_equal(by_path[k], facade._act_scales[k])


def test_facade_sync_params_requantizes_with_kept_scales(facade, tmp_path):
    """sync_params on a quantized facade keeps the calibration scales and
    requantizes the new weights with them; save_model writes the float
    weights, as the JAX package's does."""
    imgs = images(3, 2).astype(np.float32) / 255.0
    facade.quantize(calib_imgs=imgs, dataflow="bf16")
    scales = facade._act_scales
    params = {"convs": [dict(p, w=0.5 * p["w"])
                        for p in facade.params["convs"]]}
    state = facade.state
    facade.sync_params(params, state)
    assert facade._act_scales is scales and facade._q_dataflow == "bf16"
    want = tq.quantize_folded(network.fold_bn(params, state), scales, C,
                              SHALLOW)
    for g, w in zip(facade._folded["convs"], want["convs"]):
        assert sorted(g) == sorted(w)
        if "wq" in w:
            assert torch.equal(g["wq"], tq.gemm_weight(w["wq"]))
            assert torch.equal(g["sw"], w["sw"])

    facade.save_model(str(tmp_path / "q.npz"))
    with np.load(tmp_path / "q.npz") as f:
        assert not any("wq" in k or "sw" in k for k in f.files)
    saved, _, _, _ = load_npz(str(tmp_path / "q.npz"))
    for a, b in zip(saved["convs"], params["convs"]):
        assert sorted(a) == sorted(b)
        for k in b:
            assert torch.equal(a[k], b[k])


def test_facade_uint8_wire_composes(facade):
    """int8 inference takes the uint8 wire: predict_batch on a uint8 batch
    equals it on the float [0, 1] batch of the same rasters exactly (both
    divide by 255 in float32, then run the same int8 program; the JAX
    package holds this to a detection-set tolerance, its two input dtypes
    being two compiled programs)."""
    u8 = images(4, 2)
    f32 = u8.astype(np.float32) / 255.0
    facade.quantize(calib_imgs=f32)
    got_f, got_u = facade.predict_batch(f32), facade.predict_batch(u8)
    assert int(got_f[3].min()) > 0
    for a, b in zip(got_u, got_f):
        assert torch.equal(a, b)
