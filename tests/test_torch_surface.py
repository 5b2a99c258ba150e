"""The port's package surface beside the JAX package's:

  - ``models.topology.darknet53`` (the legacy YOLOv3 backbone, which no
    model calls) makes the JAX function's sequence of ``conv`` and ``add``
    calls, with the same filters, kernels, activations and downsampling,
    and its forward on the port's ops at 64 px gives three routes at
    strides 8, 16 and 32;
  - ``__version__`` and a lazy ``serving`` attribute, as the JAX package's
    ``__init__`` has them;
  - the console scripts of ``pyproject.toml``: the port's two name its
    tools' ``main``s, beside the JAX package's two, and no other.
"""

import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest
import torch

import yolov4tpu
from yolov4tpu.models import topology as jtopology
import yolov4tpu_torch
from yolov4tpu_torch.models import network
from yolov4tpu_torch.models import topology as ttopology

REPO = pathlib.Path(__file__).resolve().parents[1]


class _RecorderOps:
    """Records every call with its arguments and traces (h, w, c)."""

    def __init__(self):
        self.calls = []

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        self.calls.append(("conv", x, filters, kernel_size, downsampling,
                           activation, batch_norm))
        h, w, _ = x
        return (h // 2, w // 2, filters) if downsampling else (h, w, filters)

    def add(self, a, b):
        assert a == b, (a, b)
        self.calls.append(("add", a))
        return a


def test_darknet53_calls_match_jax():
    got, want = _RecorderOps(), _RecorderOps()
    routes = ttopology.darknet53(got, (416, 416, 3))
    assert routes == jtopology.darknet53(want, (416, 416, 3))
    assert got.calls == want.calls
    assert routes == ((52, 52, 256), (26, 26, 512), (13, 13, 1024))
    convs = [c for c in got.calls if c[0] == "conv"]
    assert len(convs) == 52 and sum(c[4] for c in convs) == 5
    assert sum(c[0] == "add" for c in got.calls) == 23


def test_darknet53_forward_on_the_ports_ops():
    init = network._InitOps(np.random.default_rng(0))
    shapes = ttopology.darknet53(init, network._ShapeVal(64, 64, 3))
    ops = network._ApplyOps({"convs": init.params}, {"bn": init.state},
                            train=False)
    x = torch.rand(1, 3, 64, 64)
    with torch.inference_mode():
        routes = ttopology.darknet53(ops, x)
    assert ops.i == len(init.params) == 52
    assert [tuple(r.shape) for r in routes] == [
        (1, 256, 8, 8), (1, 512, 4, 4), (1, 1024, 2, 2)]
    assert [(s.h, s.w, s.c) for s in shapes] == [
        (8, 8, 256), (4, 4, 512), (2, 2, 1024)]
    assert all(bool(torch.isfinite(r).all()) for r in routes)


def test_version_and_lazy_serving():
    assert yolov4tpu_torch.__version__ == yolov4tpu.__version__
    code = ("import sys, yolov4tpu_torch\n"
            "assert 'yolov4tpu_torch.serving' not in sys.modules\n"
            "serving = yolov4tpu_torch.serving\n"
            "assert serving is sys.modules['yolov4tpu_torch.serving']\n"
            "assert callable(serving.export_detector)\n"
            "assert callable(serving.load_detector)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with pytest.raises(AttributeError):
        yolov4tpu_torch.no_such_name


def test_console_scripts_name_the_ports_tools():
    import importlib
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "project"]["scripts"]
    assert scripts == {
        "yolov4tpu-xml-to-txt": "yolov4tpu.tools.xml_to_txt:main",
        "yolov4tpu-video": "yolov4tpu.tools.video:main",
        "yolov4tpu-torch-xml-to-txt": "yolov4tpu_torch.tools.xml_to_txt:main",
        "yolov4tpu-torch-video": "yolov4tpu_torch.tools.video:main"}
    for name in ("yolov4tpu-torch-xml-to-txt", "yolov4tpu-torch-video"):
        module, attr = scripts[name].split(":")
        main = getattr(importlib.import_module(module), attr)
        with pytest.raises(SystemExit) as exc:
            main(["--help"])
        assert exc.value.code == 0
