"""The port's rules, checked on the CPU: it imports nothing of JAX or of
the JAX package, its entry points default to the card and raise without
one, and its configuration is the JAX package's.
"""

import ast
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_parity import IMG, SHALLOW
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
REFERENCE_DICT = {"img_size": [IMG, IMG, 3], "max_boxes": 50, "num_gpu": 2,
                  "score_threshold": 0.4, "xyscale": [1.2, 1.1, 1.05]}


def test_port_imports_nothing_of_jax():
    code = ("import sys, yolov4tpu_torch, yolov4tpu_torch.api, "
            "yolov4tpu_torch.weights, yolov4tpu_torch.ops.nms_cuda, "
            "yolov4tpu_torch.train, yolov4tpu_torch.losses, "
            "yolov4tpu_torch.data.encode, yolov4tpu_torch.data.pipeline, "
            "yolov4tpu_torch.ops.wgrad_cuda, yolov4tpu_torch.evalmap, "
            "yolov4tpu_torch.utils.stream, yolov4tpu_torch.utils.io, "
            "yolov4tpu_torch.tools.xml_to_txt, "
            "yolov4tpu_torch.tools.measure, "
            "yolov4tpu_torch.tools.wgrad_probe, yolov4tpu_torch.checkpoint, "
            "yolov4tpu_torch.callbacks, yolov4tpu_torch.models.quantize, "
            "yolov4tpu_torch.serving, yolov4tpu_torch.native, "
            "yolov4tpu_torch.parallel, yolov4tpu_torch.parallel.mesh, "
            "yolov4tpu_torch.utils.metrics, yolov4tpu_torch.utils.profiling, "
            "yolov4tpu_torch.tools.video\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'yolov4tpu' or "
            "m.startswith('yolov4tpu.'))\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in
    [REPO / "chip_smoke.py", *(REPO / "yolov4tpu_torch").rglob("*.py")]))
def test_port_sources_import_no_jax(path):
    roots = {name.split(".")[0] for name in _imports(REPO / path)}
    assert not roots & {"jax", "jaxlib", "yolov4tpu", "flax", "optax"}, roots


def test_default_device_is_cuda_and_raises_without_it(tiny_classes):
    assert not torch.cuda.is_available()
    cfg = YoloConfig(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Yolov4(None, tiny_classes, config=cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Yolov4(None, tiny_classes, config=cfg, device="cuda")


def test_trainer_and_fit_default_to_cuda_and_raise_without_it(tiny_classes):
    assert not torch.cuda.is_available()
    cfg = YoloConfig(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)
    params = {"convs": [{"w": torch.zeros(1, 1, 1, 1),
                         "b": torch.zeros(1)}]}
    state = {"bn": [None]}
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            ttrain.Trainer(cfg, 3, params, state, **kw)
    # The facade's fit builds its trainer on the facade's device, which
    # defaults to the card and raises at construction.
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tapi.Yolov4(None, tiny_classes, config=cfg).fit(None, 1)


def test_config_matches_jax():
    for got, want in [(YoloConfig(), JaxConfig()),
                      (tapi._config_from_dict(REFERENCE_DICT),
                       japi._config_from_dict(REFERENCE_DICT))]:
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        np.testing.assert_array_equal(got.anchors_grouped,
                                      want.anchors_grouped)
        assert got.grid_sizes() == want.grid_sizes()
