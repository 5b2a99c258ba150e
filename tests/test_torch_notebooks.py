"""The three notebooks' journeys (``notebook/*.ipynb``) through the port on
the CPU: their code cells run verbatim, except for an asserted substitution
table that points them at ``yolov4tpu_torch`` on the CPU, in float32, and
cuts the training journey to 64 px, shallow, one epoch.  Every
substitution must hit, so a notebook that drifts fails here.  The working
directory is ``tests/test_notebooks.py``'s: synthetic COCO weights, one
street image and a tiny 3-class training set.
"""

import os

import torch.distributed as dist

from _torch_parity import no_cluster  # noqa: F401  (fixture)
from test_notebooks import _cells, _run, nb_dir  # noqa: F401  (fixture)

# Every notebook: the port's package, on the CPU, in float32 (the CPU's
# bfloat16 convolutions are slow; the code path is the same).
PORT = [
    ("from yolov4tpu", "from yolov4tpu_torch"),
    ("Yolov4(weight_path=", "Yolov4(device='cpu', weight_path="),
]
FLOAT32 = [("compute_dtype='bfloat16'", "compute_dtype='float32'")]


def test_inference_notebook(nb_dir):  # noqa: F811
    ns = _run(_cells("Inference.ipynb"), PORT + FLOAT32, nb_dir)
    assert ns["model"].device.type == "cpu"
    assert list(ns["detections"].columns) == [
        "x1", "y1", "x2", "y2", "class_name", "score", "w", "h"]
    assert [tuple(g.shape[1:]) for g in ns["raw_grids"]] == [
        (52, 52, 255), (26, 26, 255), (13, 13, 255)]


def test_inference_colab_notebook(nb_dir, no_cluster):  # noqa: F811
    ns = _run(_cells("Inference-colab.ipynb"), PORT + FLOAT32 + [
        # One process per card: the port's mesh is a process group, here
        # one rank on the CPU, where the JAX notebook lists its devices.
        ("import jax\njax.devices()  # expect TpuDevice entries",
         "from yolov4tpu_torch.parallel import init_distributed\n"
         "init_distributed(num_processes=1, backend='gloo')"),
        ("model.distribute()", "model.distribute(1)"),
        ("(len(jax.devices()) * 8, 416, 416, 3)", "(1, 416, 416, 3)"),
    ], nb_dir)
    assert ns["model"]._mesh.size == 1
    assert ns["valid"].shape[0] == dist.get_world_size() == 1


def test_train_notebook(nb_dir):  # noqa: F811
    ns = _run(_cells("train.ipynb"), PORT + [
        # Full-depth 416^2 training is a job for the card; the journey runs
        # the same code on a 64^2 shallow variant for one epoch.
        ("cfg = YoloConfig(batch_size=8, compute_dtype='bfloat16',\n"
         "                 use_mosaic=True, label_smoothing=0.1)",
         "cfg = YoloConfig(batch_size=2, img_size=(64, 64, 3),\n"
         "                 csp_repeats=(1, 1, 1, 1, 1),\n"
         "                 use_mosaic=True, label_smoothing=0.1)"),
        ("epochs=100", "epochs=1"),
    ], nb_dir)
    assert ns["model"].device.type == "cpu"
    assert os.path.exists(nb_dir / "ckpts" / "latest.npz")
    out = open(nb_dir / "eval" / "result" / "output.txt").read()
    assert "mAP" in out
    assert ns["model"].num_classes == 3
