"""The plain reference against the program at a tiny size on the CPU.
The reference imports nothing of the program; this test imports both."""

import numpy as np
import pytest
import torch

from perfbench.harness import env, weights
from perfbench.harness.scene import scene
from perfbench.reference import (decode, encode, ingest, judge_infer,
                                 judge_train, loss, nms, train, yolov4)
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.encode import preprocess_true_boxes
from yolov4tpu_torch.losses import yolo_loss
from yolov4tpu_torch.models import network

DEPTH = (1, 1, 1, 1, 1)
C = 80


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    params, state = weights.make(5, 128, C, "cpu", DEPTH)
    cal = scene(6, 4, 128, 128, "cpu")
    weights.calibrate(params, state, torch.as_tensor(cal).float() / 255, C,
                      0.3, 60.0, depth=DEPTH)
    return params, state


@pytest.mark.parametrize("s2d", [False, True])
def test_folded_forward_matches(model, s2d):
    params, state = model
    x = torch.as_tensor(scene(1, 2, 128, 128, "cpu")).float() / 255
    mine = yolov4.forward_folded(yolov4.fold_bn(params, state), x, C,
                                 depth=DEPTH)
    folded = network.prepare_folded(network.fold_bn(params, state), "cpu")
    theirs = network.apply_folded(folded, x, C, csp_repeats=DEPTH,
                                  s2d_stem=s2d)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4)


def test_served_detections_judge_exact_at_float32(model, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    params, state = model
    imgs = scene(7, 4, 128, 128, "cpu")
    classes = env.write_classes(tmp_path / "c.txt", C)
    m = Yolov4(class_name_path=str(classes), device="cpu",
               config=YoloConfig(img_size=(128, 128, 3), csp_repeats=DEPTH))
    m.sync_params(params, state)
    served = [o.numpy() for o in m.predict_batch(imgs)]
    assert served[3].min() > 5       # busy images
    raws = yolov4.forward_folded(yolov4.fold_bn(params, state),
                                 torch.as_tensor(imgs).float() / 255, C,
                                 depth=DEPTH)
    boxes, scores = decode.decode(raws, C, 128)

    def numbers():
        return judge_infer.judge(boxes, scores, served, 0.413, 0.3, 100,
                                 256).numbers()

    got = numbers()
    assert got["det_gap"] < 2e-6 and got["nms_gap"] == 0.0
    assert got["det_median"] < 1e-6 and got["nms_breaches"] == 0
    # The reference's own NMS serves what the port serves.
    ref = nms.serve(boxes, scores, 0.413, 0.3, 100, 256)
    assert (ref[3] == served[3]).all() and (ref[2] == served[2]).all()
    assert np.allclose(ref[0], served[0], atol=2e-6)
    assert np.allclose(ref[1], served[1], atol=2e-6)
    # One answer altered where it is produced: the judge sees it.
    served[0][0, 0] += 0.05
    assert numbers()["det_gap"] > 0.04
    # The best answer left out: the least excuse of its absence (a lower
    # box's suppression, short of the IoU threshold) is far from 0.
    served[0][0, 0] -= 0.05
    for k in range(3):
        served[k][0, :-1] = served[k][0, 1:].copy()
        served[k][0, -1] = 0
    served[3][0] -= 1
    assert numbers()["nms_gap"] > 0.03 and numbers()["nms_breaches"] >= 1


def test_encoder_is_bit_equal():
    rng = np.random.default_rng(3)
    boxes = np.zeros((3, 20, 5), np.float32)
    for i in range(3):
        for j in range(rng.integers(1, 20)):
            x1, y1 = rng.integers(0, 400, 2)
            w, h = rng.integers(4, 200, 2)
            boxes[i, j] = (x1, y1, min(x1 + w, 416), min(y1 + h, 416),
                           rng.integers(0, C))
    boxes[0, 1] = boxes[0, 0]             # a collision: class flags add up
    boxes[0, 1, 4] = (boxes[0, 0, 4] + 1) % C
    mine, mxy = encode.encode(boxes, 416, C)
    theirs, txy = preprocess_true_boxes(
        boxes, (416, 416), YoloConfig().anchors_flat, C)
    for a, b in zip(mine, theirs):
        assert np.array_equal(a, b)
    assert np.array_equal(mxy, txy)


def test_ingest_matches_the_native_resize(tmp_path):
    import cv2
    from yolov4tpu_torch import native
    img = scene(2, 1, 48, 64, "cpu")[0]
    path = tmp_path / "a.png"
    cv2.imwrite(str(path), img[:, :, ::-1])
    mine, boxes = ingest.sample(str(path), np.array([[4, 6, 30, 40, 1]],
                                                    np.float32), 96)
    theirs = native.resize_bilinear_batch([img], (96, 96))[0]
    # The native resize places its taps in float32: 1e-7 of a coordinate
    # across a step of up to 255 levels.
    assert np.abs(mine - theirs).max() < 1e-5
    assert np.allclose(boxes[0, :4], [6, 12, 45, 80])


def test_loss_and_training_forward_match(model):
    params, state = model
    rng = np.random.default_rng(4)
    x = torch.as_tensor(scene(3, 4, 128, 128, "cpu")).float() / 255
    boxes = np.zeros((4, 10, 5), np.float32)
    for i in range(4):
        for j in range(5):
            x1, y1 = rng.integers(0, 100, 2)
            boxes[i, j] = (x1, y1, x1 + rng.integers(8, 28),
                           y1 + rng.integers(8, 28), rng.integers(0, C))
    labels, xywh = encode.encode(boxes, 128, C)
    tl = [torch.as_tensor(v) for v in labels]
    raws = yolov4.forward_train(params, x, C, depth=DEPTH, remat=False)
    theirs, _ = network.apply(params, state, x, C, train=True,
                              csp_repeats=DEPTH)
    # The program's single-exp mish differs from x * tanh(softplus(x)) by
    # up to 1.5e-4, and batch statistics over 4 images of 4x4 deep grids
    # amplify it: held by relative RMS.
    for a, b in zip(raws, theirs):
        assert float((a - b).norm() / b.norm()) < 1e-3
    mine = loss.yolo_loss(theirs, tl, torch.as_tensor(xywh), C)
    ref = yolo_loss(theirs, tl, torch.as_tensor(xywh),
                    YoloConfig().anchors_grouped, (8, 16, 32), C, 0.5)
    assert torch.allclose(mine, ref, rtol=1e-6)


def test_reference_step_is_adam_and_remat_changes_nothing(model):
    params, _ = model
    rng = np.random.default_rng(5)
    img = scene(4, 2, 64, 64, "cpu").astype(np.float32) / 255
    boxes = np.zeros((2, 4, 5), np.float32)
    boxes[:, 0] = (8, 8, 40, 30, 3)
    labels, xywh = encode.encode(boxes, 64, C)
    small, _ = weights.make(9, 64, C, "cpu", DEPTH)
    batch = [(img, labels, xywh)]
    losses, grad, last = train.run_steps(small, batch, C, 1, device="cpu",
                                         depth=DEPTH)
    # torch.optim.Adam over the same gradient.
    ts = [t.detach().clone().requires_grad_(True)
          for t in train.leaves(small)]
    opt = torch.optim.Adam(ts, lr=1e-4, eps=1e-8)
    for t, g in zip(ts, grad):
        t.grad = g.clone()
    opt.step()
    for a, b in zip(last, ts):
        assert torch.allclose(a, b.detach(), rtol=0, atol=1e-9)
    # The checkpointed forward gives the gradient the plain one gives.
    live = {"convs": [{k: v.detach().clone().requires_grad_(True)
                       for k, v in p.items()} for p in small["convs"]]}
    with yolov4.strict_fp32():
        raws = yolov4.forward_train(live, torch.as_tensor(img), C,
                                    depth=DEPTH, remat=False)
        total = loss.yolo_loss(raws, [torch.as_tensor(v) for v in labels],
                               torch.as_tensor(xywh), C)
        plain = torch.autograd.grad(total, train.leaves(live))
    assert abs(float(total) - losses[0]) <= 1e-6 * abs(losses[0])
    assert judge_train.worst_leaf(grad, plain) < 1e-5
