"""The port's AOT export (``serving.export_detector`` / ``load_detector``,
``torch.export``) on the CPU, case for case as tests/test_serving.py holds
the JAX package's: the loaded artifact of a quantized facade (uint8
input, custom thresholds, ``nms_impl="fast"``) reproduces the live
``predict_batch``, and the export guards raise as the JAX package's.  The
float ``"xla"`` artifact without the port's ops is in
test_torch_serving_jax.py; the float ``"fast"`` and ``"pallas"``
artifacts run in ``chip_smoke.py`` on the card.
"""

import copy

import numpy as np
import pytest
import torch

from _torch_parity import IMG, SHALLOW, images, port_calibrated
from yolov4tpu_torch import serving
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.ops import nms_cuda

C = 3
BATCH = 2


@pytest.fixture(scope="module")
def model(tiny_classes):
    """A float "fast" facade on the CPU with weights that detect (~30 boxes
    an image clear 0.3)."""
    params, state, _ = port_calibrated(C)
    m = Yolov4(None, tiny_classes, device="cpu",
               config=YoloConfig(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW,
                                 nms_pre_top_k=64))
    m.sync_params(params, state)
    return m


def _port_ops(exported):
    return sorted({str(n.target) for n in exported.graph.nodes
                   if n.op == "call_function"
                   and str(n.target).startswith("yolov4tpu_torch")})


@pytest.fixture(scope="module")
def artifact(model, tmp_path_factory):
    """A quantized copy of the model (int8 dataflow), exported at b2 for
    uint8 input with custom thresholds (IoU 0.5, score 0.2), written and
    loaded: (the quantized facade, path, exported program, detect).  One
    artifact serves the cases below: each export, write and load of the
    shallow program costs seconds on the CPU."""
    quantized = copy.copy(model).quantize(
        calib_imgs=images(1, 4).astype(np.float32) / 255.0)
    path = str(tmp_path_factory.mktemp("serving") / "int8_u8.pt2")
    exported = serving.export_detector(quantized, path, batch_size=BATCH,
                                       iou_threshold=0.5, score_threshold=0.2,
                                       input_dtype="uint8")
    return quantized, path, exported, serving.load_detector(path,
                                                            device="cpu")


def test_export_load_round_trip(artifact):
    """The loaded "fast" artifact equals predict_batch within 1e-5 (valid
    counts equal), runs the rank NMS custom op (on the CPU: its plain
    version, so no kernel launch is counted), and is a file on disk."""
    quantized, path, exported, detect = artifact
    assert _port_ops(exported) == ["yolov4tpu_torch.suppress_rank.default"]
    with open(path, "rb") as f:
        assert len(f.read()) > 1000
    u8 = images(2, BATCH)
    launches = nms_cuda.LAUNCHES
    got = detect(u8)
    assert nms_cuda.LAUNCHES == launches
    want = quantized.predict_batch(u8, 0.5, 0.2)
    assert got[0].shape == want[0].shape and int(want[3].min()) > 0
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_export_custom_thresholds(artifact):
    """The thresholds are constants of the program: the artifact gives the
    live model's detections at them, not at the configured ones."""
    quantized, _, _, detect = artifact
    u8 = images(3, BATCH)
    got = detect(u8)
    assert int(got[3].min()) > 0
    assert not torch.equal(got[3], quantized.predict_batch(u8)[3])
    assert torch.equal(got[3], quantized.predict_batch(u8, 0.5, 0.2)[3])


def test_export_quantized_model(model, artifact):
    """A quantized facade's artifact bakes in the int8 program: int8
    weights in its state and int8 GEMMs in its graph, and detections that
    are the quantized model's, not the float one's."""
    quantized, _, exported, detect = artifact
    int8 = [k for k, v in exported.state_dict.items() if v.dtype == torch.int8]
    assert len(int8) == sum("wq" in p for p in quantized._folded["convs"])
    assert sum(str(n.target) == "aten._int_mm.default"
               for n in exported.graph.nodes) == len(int8)
    u8 = images(5, BATCH)
    got = detect(u8)
    float_out = model.predict_batch(u8, 0.5, 0.2)
    assert not all(torch.equal(a, b) for a, b in zip(got, float_out))
    for g, w in zip(got, quantized.predict_batch(u8, 0.5, 0.2)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_export_uint8_input(artifact):
    """input_dtype="uint8" bakes the /255 in: the artifact takes raw uint8
    rasters, states its signature, and refuses float input or another
    shape with ValueError."""
    quantized, path, _, detect = artifact
    assert detect.input_shape == (BATCH, IMG, IMG, 3)
    assert detect.input_dtype == np.uint8
    u8 = images(6, BATCH)
    with pytest.raises(ValueError, match="uint8"):
        detect(u8.astype(np.float32) / 255.0)
    with pytest.raises(ValueError, match="shape"):
        detect(u8[:1])
    with pytest.raises(ValueError, match="'float32' or 'uint8'"):
        serving.export_detector(quantized, path + ".x", input_dtype="int4")


def test_export_multiplatform_requires_xla_nms(model, tmp_path):
    """The NMS custom ops are single-platform: a two-platform export of
    "fast" or "pallas" raises before tracing, as the JAX package's does;
    platforms outside the three it takes raise too."""
    for impl in ("fast", "pallas"):
        m = copy.copy(model)
        m.config = model.config.replace(nms_impl=impl)
        with pytest.raises(ValueError, match="multi-platform"):
            serving.export_detector(m, str(tmp_path / "x.pt2"),
                                    platforms=("cuda", "cpu"))
    with pytest.raises(ValueError, match="platforms must be one of"):
        serving.export_detector(model, str(tmp_path / "x.pt2"),
                                platforms=("tpu",))
    assert not (tmp_path / "x.pt2").exists()


def test_load_refuses_a_device_it_was_not_exported_for(artifact):
    """A CPU artifact is not run elsewhere: asking for the card raises
    (here, without CUDA, when the device is resolved)."""
    _, path, _, _ = artifact
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serving.load_detector(path)
