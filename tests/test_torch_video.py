"""The port's video tool (``yolov4tpu_torch.tools.video``) against the JAX
package's (``yolov4tpu.tools.video``), as ``tests/test_video.py`` drives
the latter: a synthetic mp4v clip in, an annotated clip out, on the same
density-calibrated weights.

  - the frame count returned and read back from the written file, and
    ``max_frames``;
  - each frame's detections (``predict_batch``'s outputs, recorded on both
    facades) within the port's contract with the JAX package, 1e-3 per box
    and score;
  - the uint8 wire's detections equal to the float wire's, and the two
    written clips alike;
  - the command line builds its facade on the card by default, so it
    raises here.
"""

import numpy as np
import pytest

from _torch_parity import (IMG, SHALLOW, assert_detections_equal,
                           port_calibrated, to_numpy)
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.tools.video import annotate_video as jax_annotate_video
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_to_jax
from yolov4tpu_torch.tools import video

C = 3
FRAMES, BS = 7, 3


def _write_clip(path, frames: int, seed: int):
    import cv2
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"),
                             10.0, (96, 64))
    rng = np.random.default_rng(seed)
    for _ in range(frames):
        writer.write(rng.uniform(0, 255, (64, 96, 3)).astype(np.uint8))
    writer.release()


def _count_frames(path) -> int:
    import cv2
    cap = cv2.VideoCapture(str(path))
    assert cap.isOpened()
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    return frames


def _recording(monkeypatch, model):
    """Record each ``predict_batch`` output of ``model`` as numpy arrays."""
    calls, real = [], model.predict_batch

    def predict_batch(*a, **k):
        out = real(*a, **k)
        calls.append([to_numpy(o) for o in out])
        return out

    monkeypatch.setattr(model, "predict_batch", predict_batch)
    return calls


@pytest.fixture(scope="module")
def models(tiny_classes):
    params, state, _ = port_calibrated(C)
    kw = dict(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)
    tm = tapi.Yolov4(None, tiny_classes, config=YoloConfig(**kw),
                     device="cpu")
    tm.sync_params(params, state)
    jm = japi.Yolov4(None, tiny_classes, config=JaxConfig(**kw))
    jm.sync_params(*params_to_jax(params, state))
    return tm, jm


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    path = tmp_path_factory.mktemp("video") / "in.mp4"
    _write_clip(path, FRAMES, 0)
    return path


def test_annotate_video_matches_jax(models, clip, tmp_path, monkeypatch):
    tm, jm = models
    got = _recording(monkeypatch, tm)
    want = _recording(monkeypatch, jm)
    n = video.annotate_video(tm, str(clip), str(tmp_path / "port.mp4"),
                             bs=BS, verbose=False)
    assert n == jax_annotate_video(jm, str(clip), str(tmp_path / "jax.mp4"),
                                   bs=BS, verbose=False) == FRAMES
    assert _count_frames(tmp_path / "port.mp4") == FRAMES
    # The port does not pad its batches; the JAX loader pads each to bs.
    assert [len(c[3]) for c in got] == [3, 3, 1]
    assert [len(c[3]) for c in want] == [3, 3, 3]
    frames = 0
    for g, w in zip(got, want):
        b = len(g[3])
        assert g[3].min() >= 5   # detections survive NMS
        assert_detections_equal(g, [o[:b] for o in w], box_atol=1e-3,
                                score_atol=1e-3)
        frames += b
    assert frames == FRAMES


def test_annotate_video_max_frames(models, clip, tmp_path):
    out = tmp_path / "o.mp4"
    assert video.annotate_video(models[0], str(clip), str(out), bs=4,
                                max_frames=5, verbose=False) == 5
    assert _count_frames(out) == 5


def test_annotate_video_uint8_wire(models, clip, tmp_path, monkeypatch):
    """config.transfer_uint8 ships the resized uint8 frames and divides on
    the device: the same detections as the float wire, so alike clips
    (mp4 is lossy, hence the JAX test's mean bound on decoded frames)."""
    import dataclasses

    import cv2
    tm = models[0]
    calls = _recording(monkeypatch, tm)
    n_f = video.annotate_video(tm, str(clip), str(tmp_path / "of.mp4"),
                               bs=BS, verbose=False)
    float_calls = list(calls)
    calls.clear()
    monkeypatch.setattr(tm, "config",
                        dataclasses.replace(tm.config, transfer_uint8=True))
    n_u = video.annotate_video(tm, str(clip), str(tmp_path / "ou.mp4"),
                               bs=BS, verbose=False)
    assert n_f == n_u == FRAMES
    assert len(calls) == len(float_calls) == 3
    for u, f in zip(calls, float_calls):
        for a, b in zip(u, f):
            np.testing.assert_array_equal(a, b)
    cf = cv2.VideoCapture(str(tmp_path / "of.mp4"))
    cu = cv2.VideoCapture(str(tmp_path / "ou.mp4"))
    while True:
        okf, ff = cf.read()
        oku, fu = cu.read()
        assert okf == oku
        if not okf:
            break
        assert np.abs(ff.astype(np.int16) - fu.astype(np.int16)).mean() < 2.0


def test_command_line_runs_on_the_card(clip, tmp_path, tiny_classes):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        video.main(["--weights", str(tmp_path / "yolov4.weights"),
                    "--classes", tiny_classes, "--input", str(clip),
                    "--output", str(tmp_path / "o.mp4")])
