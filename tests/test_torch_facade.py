"""The port's ``Yolov4`` facade has every method of the JAX package's:
the ones not ported yet raise ``NotImplementedError`` naming their item in
``ROADMAP.md`` (not ``AttributeError``), and take the JAX signatures.
"""

import inspect

import pytest

from _torch_parity import IMG, SHALLOW
from yolov4tpu import api as japi
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig

# method -> (arguments of the call, the ROADMAP.md item its message names)
STUBS = {
    "save_model": (("model.weights",), "item 13"),
    "load_model": (("model.weights",), "item 13"),
    "dequantize": ((), "item 10"),
    "distribute": ((), "item 14"),
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
