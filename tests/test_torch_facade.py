"""The port's ``Yolov4`` facade has every method of the JAX package's:
the options not ported yet (``distribute(axis="spatial")``) raise
``NotImplementedError`` naming their item in ``ROADMAP.md`` (not
``AttributeError``), and the methods take the JAX signatures; the
ported ``save_model`` / ``load_model`` round-trip the weights exactly
(``quantize`` / ``dequantize``: test_torch_quantize_facade.py).
"""

import inspect

import numpy as np
import pytest
import torch

from _torch_parity import IMG, SHALLOW, images
from yolov4tpu import api as japi
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.weights import force_busy_heads

# method -> (arguments of the call, the ROADMAP.md item its message names)
STUBS = {
    "distribute": ((None, "spatial"), "item 14"),
}


@pytest.fixture(scope="module")
def model(tiny_classes):
    return tapi.Yolov4(None, tiny_classes, device="cpu",
                       config=YoloConfig(img_size=(IMG, IMG, 3),
                                         csp_repeats=SHALLOW))


@pytest.mark.parametrize("name", sorted(STUBS))
def test_unported_method_raises_naming_its_item(model, name):
    args, item = STUBS[name]
    with pytest.raises(NotImplementedError,
                       match=f"ROADMAP.md queue A {item}"):
        getattr(model, name)(*args)
    # The stub takes the JAX package's parameters, in the same order.
    want = list(inspect.signature(getattr(japi.Yolov4, name)).parameters)
    got = list(inspect.signature(getattr(tapi.Yolov4, name)).parameters)
    assert got == want


def test_stub_list_follows_the_reference():
    """Every stubbed name is a method of the JAX ``Yolov4``, so the list
    shrinks as the reference's surface is ported, never drifts from it."""
    for name in STUBS:
        assert callable(getattr(japi.Yolov4, name, None)), name


@pytest.fixture(scope="module")
def full(tiny_classes):
    """Two full-depth facades at 64 px (``.weights`` files hold the full
    network): the first with busy heads so it detects, the second built
    from another seed and with another IoU threshold."""
    cfg = YoloConfig(img_size=(IMG, IMG, 3))
    first = tapi.Yolov4(None, tiny_classes, device="cpu", config=cfg)
    first.sync_params(force_busy_heads(first.params, 3), first.state)
    second = tapi.Yolov4(None, tiny_classes, device="cpu", seed=1,
                         config=cfg.replace(iou_threshold=0.3))
    return first, second


@pytest.mark.parametrize("name,saved", [("model.weights", "model.weights"),
                                        ("model.npz", "model.npz"),
                                        ("model", "model.npz")])
def test_save_and_load_model_round_trip(full, tmp_path, name, saved):
    """save_model -> load_model on a second facade: the same weights, so
    the same detections exactly; a path that is not ``.weights`` gets
    ``.npz`` appended; the configured thresholds are kept; the signatures
    are the JAX package's."""
    for method in ("save_model", "load_model"):
        want = list(inspect.signature(getattr(japi.Yolov4, method)).parameters)
        got = list(inspect.signature(getattr(tapi.Yolov4, method)).parameters)
        assert got == want
    model, other = full
    thresholds = (model.config.iou_threshold, model.config.score_threshold)
    imgs = images(4, 2).astype(np.float32) / 255.0
    before = model.predict_batch(imgs, *thresholds)
    assert int(before[3].min()) > 0
    model.save_model(str(tmp_path / name))
    assert sorted(p.name for p in tmp_path.iterdir()) == [saved]

    other.load_model(str(tmp_path / saved))
    assert other.config.iou_threshold == 0.3
    for a, b in zip(other.params["convs"], model.params["convs"]):
        for k in a:
            assert torch.equal(a[k], b[k])
    for a, b in zip(other.state["bn"], model.state["bn"]):
        assert (a is None) == (b is None)
        for k in (a or {}):
            assert torch.equal(a[k], b[k])
    after = other.predict_batch(imgs, *thresholds)
    for a, b in zip(after, before):
        assert torch.equal(a, b)
