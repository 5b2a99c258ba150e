"""A run with the timed path broken underneath comes out not correct:
past run.py's look for a card, on the CPU at a tiny size, with limits
set well above the clean run's readings on the same seed."""

import json

import pytest
import torch

from _tiny import OFF, REPO, TRAIN, make_root, readings, run

SEED = 2 ** 31 + 19
HELD = {OFF: "yolov4-416-coco80.offline-b64",
        TRAIN: "yolov4-608-coco80.train-b32"}


def _limited(tmp_path, cell, dtype="bfloat16"):
    """A checkout whose cell holds the numbers its full-size twin holds,
    each to three times what the clean run reads here (and at least
    1e-6): the clean run is correct."""
    clean = make_root(tmp_path / "clean", dtype=dtype)
    seen = readings(run(clean, cell, SEED, every=True))
    held = json.loads((REPO / "perfbench/limits" / f"{HELD[cell]}.json")
                      .read_text())
    limits = {k: max(3 * seen[k], 1e-6) for k in held}
    root = make_root(tmp_path / "held", dtype=dtype, limits={cell: limits})
    assert run(root, cell, SEED)["correct"]
    return root


def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = _limited(tmp_path, OFF)
    from yolov4tpu_torch.api import Yolov4
    real = Yolov4.predict_batch

    def altered(self, imgs, *a, **k):       # every box moved where made
        boxes, scores, classes, valid = real(self, imgs, *a, **k)
        return boxes + 0.02 * (scores > 0)[..., None], scores, classes, valid

    monkeypatch.setattr(Yolov4, "predict_batch", altered)
    assert not run(root, OFF, SEED)["correct"]


def test_skipped_suppression_is_not_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = _limited(tmp_path, OFF)
    from yolov4tpu_torch.ops import nms_cuda

    def keep_all(coords, scores, rank, iou_t, score_t, max_per_class):
        return (scores > score_t).to(scores.dtype)

    monkeypatch.setattr(nms_cuda, "suppress_rank", keep_all)
    assert not run(root, OFF, SEED)["correct"]


def test_dropped_detections_are_not_correct(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = _limited(tmp_path, OFF)
    from yolov4tpu_torch.api import Yolov4
    real = Yolov4.predict_batch

    def dropped(self, imgs, *a, **k):    # the lower-scored half of image 0
        boxes, scores, classes, valid = (t.clone() for t in
                                         real(self, imgs, *a, **k))
        n = int(valid[0])
        for t in (boxes, scores, classes):
            t[0, (n + 1) // 2:] = 0
        valid[0] = (n + 1) // 2
        return boxes, scores, classes, valid

    monkeypatch.setattr(Yolov4, "predict_batch", dropped)
    assert not run(root, OFF, SEED)["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_a_broken_step_is_not_correct(fault, tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = _limited(tmp_path, TRAIN, dtype="float32")
    from yolov4tpu_torch import train
    real_step, real_train = train.Adam.step, train.Trainer.train_step

    def step(self, grads):
        before = [t.detach().clone() for t in self.tensors]
        real_step(self, grads)
        with torch.no_grad():
            if fault == "unchanged":        # the state returned unchanged
                for t, b in zip(self.tensors, before):
                    t.copy_(b)
            elif fault == "altered":        # one leaf's update altered
                self.tensors[0].add_(1e-3)

    def half(self, batch):                  # the mean over half the rows
        rows = len(batch["image"]) // 2
        return real_train(self, train.tree_map(lambda x: x[:rows], batch))

    if fault == "half_batch":
        monkeypatch.setattr(train.Trainer, "train_step", half)
    else:
        monkeypatch.setattr(train.Adam, "step", step)
    assert not run(root, TRAIN, SEED)["correct"]
