"""A package-free artifact of the port (``platforms=("cuda", "cpu")``, the
plain ``nms_impl="xla"`` NMS): no op of the port in its program, loaded on
the CPU, equal to the live model, and within 1e-3 per box of the JAX
package's own StableHLO artifact of the same weights.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, assert_detections_equal,
                           port_calibrated)
from yolov4tpu import serving as jserving
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import serving
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import fold_bn

C = 3
KW = dict(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW, nms_impl="xla",
          nms_pre_top_k=16)


@pytest.fixture(scope="module")
def artifact(tiny_classes, tmp_path_factory):
    """(the port's facade, its two-platform artifact's path, exported
    program, loaded detect on the CPU)."""
    params, state, _ = port_calibrated(C)
    m = Yolov4(None, tiny_classes, device="cpu", config=YoloConfig(**KW))
    m.sync_params(params, state)
    path = str(tmp_path_factory.mktemp("serving") / "multi.pt2")
    exported = serving.export_detector(m, path, batch_size=1,
                                       platforms=("cuda", "cpu"))
    return m, path, exported, serving.load_detector(path, device="cpu")


def test_multiplatform_artifact_is_package_free(artifact):
    """No node of the program is an op of the port, so the file loads with
    torch alone; on the CPU it equals predict_batch within 1e-5."""
    model, _, exported, detect = artifact
    targets = {str(n.target) for n in exported.graph.nodes}
    assert not [t for t in targets if "yolov4tpu" in t]
    _, _, imgs = port_calibrated(C)
    got = detect(imgs[:1])
    want = model.predict_batch(imgs[:1])
    assert int(want[3][0]) > 0
    assert torch.equal(got[3], want[3])
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-5)


def test_artifact_matches_the_jax_artifact(artifact, tmp_path):
    """The JAX package's artifact of the same weights and configuration
    (``jax.export``, StableHLO) gives the same detections: valid counts
    and classes equal, boxes and scores within 1e-3.  The JAX side is
    exported from the attributes its ``export_detector`` reads, with the
    port's folded weights (HWIO)."""
    _, _, _, detect = artifact
    params, state, imgs = port_calibrated(C)
    folded = {"convs": [{"w": p["w"].permute(2, 3, 1, 0).numpy(),
                         "b": p["b"].numpy()}
                        for p in fold_bn(params, state)["convs"]]}
    jmodel = types.SimpleNamespace(
        config=JaxConfig(**KW), num_classes=C, img_size=(IMG, IMG, 3),
        _compute_dtype=jnp.float32, _folded=folded)
    path = str(tmp_path / "jax.shlo")
    jserving.export_detector(jmodel, path, batch_size=1, platforms=("cpu",))
    want = [np.asarray(o) for o in jserving.load_detector(path)(imgs[:1])]
    assert int(want[3][0]) > 0
    assert_detections_equal(detect(imgs[:1]), want, box_atol=1e-3,
                            score_atol=1e-3)
