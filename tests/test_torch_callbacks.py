"""The port's training callbacks against the JAX package's: the cosine LR
sequence in both of its routes, ``CheckpointCallback`` files that the JAX
package's ``load_npz`` reads, ``EvalMapCallback`` writing what the direct
``export_gt`` / ``export_prediction`` / ``eval_map`` calls write (synced
from the trainer that drives the loop), and ``fit(resume_dir=...)``
resuming at the next epoch with the step count and the learning rate the
callback had set.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, images, small_tree, torch_params,
                           train_batch)
from yolov4tpu import callbacks as jcallbacks
from yolov4tpu import checkpoint as jckpt
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch import callbacks as tcallbacks
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_from_jax, params_to_jax
from yolov4tpu_torch.weights import force_busy_heads

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW)


def _trainers(schedule=False):
    params, state = small_tree()
    js = jtrain.cosine_annealing_schedule(1e-3, 1e-5, 4, 1) if schedule \
        else None
    ts = ttrain.cosine_annealing_schedule(1e-3, 1e-5, 4, 1) if schedule \
        else None
    jt = jtrain.Trainer(JaxConfig(**KW), C, params, state, schedule=js)
    tt = ttrain.Trainer(YoloConfig(**KW), C, *params_from_jax(params, state),
                        schedule=ts, device="cpu")
    return jt, tt


@pytest.mark.parametrize("route", ["on_epoch_begin", "call"])
def test_cosine_lr_sequence_matches_jax(route):
    """Eight epochs (two cycles of 4): the LR each trainer holds and the
    callbacks' histories are equal, in the fit route (on_epoch_begin) and
    the hand-rolled route (the callback called at each epoch's end)."""
    jt, tt = _trainers()
    jcb = jcallbacks.CosineAnnealingScheduler(1e-3, 1e-5, 4)
    tcb = tcallbacks.CosineAnnealingScheduler(1e-3, 1e-5, 4)
    got, want = [], []
    for epoch in range(8):
        for cb, trainer, seen in ((jcb, jt, want), (tcb, tt, got)):
            if route == "call":
                cb(trainer, {"epoch": epoch})
            else:
                cb.on_epoch_begin(trainer, epoch)
            seen.append(trainer.learning_rate)
    assert got == want
    assert tcb.history == jcb.history
    assert len(set(got)) == 4           # it really changed, and restarted
    assert tcb.lr(3) == jcb.lr(3) and tcb.lr(4) == jcb.lr(0)


def test_cosine_callback_rejects_a_scheduled_optimizer():
    jt, tt = _trainers(schedule=True)
    for module, trainer in ((jcallbacks, jt), (tcallbacks, tt)):
        cb = module.CosineAnnealingScheduler(1e-3, 1e-5, 4)
        with pytest.raises(RuntimeError, match="mutable"):
            cb.on_epoch_begin(trainer, 0)


def test_checkpoint_callback_files_load_in_jax(tmp_path):
    _, tt = _trainers()
    tt.global_step = 5
    cb = tcallbacks.CheckpointCallback(str(tmp_path / "ck_{epoch}.npz"),
                                       every=2)
    for epoch in (0, 1, 2):
        cb(tt, {"epoch": epoch})
    assert sorted(os.listdir(tmp_path)) == ["ck_1.npz"]
    params, state, step, extra = jckpt.load_npz(str(tmp_path / "ck_1.npz"))
    assert step == 5 and extra == {"epoch": 1}
    want_p, want_s = params_to_jax(tt.params, tt.state)
    for got, want in ((params, want_p), (state, want_s)):
        flat_g, flat_w = (jckpt._flatten(t) for t in (got, want))
        assert sorted(flat_g) == sorted(flat_w)
        for k in flat_w:
            assert flat_g[k].dtype == flat_w[k].dtype
            np.testing.assert_array_equal(flat_g[k], flat_w[k])


def test_eval_callback_writes_the_direct_calls_files(tiny_classes, tmp_path):
    """The callback syncs the facade from the trainer driving the loop (a
    hand-built one the facade never saw), copies its tensors, and writes
    the files that the direct calls write."""
    import cv2
    model = tapi.Yolov4(None, tiny_classes, config=YoloConfig(**KW),
                        device="cpu")
    # Busy heads: the trainer's weights differ from the facade's and give
    # detections at 64 px.
    trainer = ttrain.Trainer(model.config, C,
                             force_busy_heads(model.params, C), model.state,
                             device="cpu")
    img_dir = tmp_path / "imgs"
    img_dir.mkdir()
    for i, img in enumerate(images(3, 2)):
        cv2.imwrite(str(img_dir / f"e{i}.jpg"), img)
    anno = tmp_path / "anno.txt"
    anno.write_text("e0.jpg 5,5,30,30,0 20,8,60,40,2\ne1.jpg 2,3,50,60,1\n")

    work = tmp_path / "cb"
    cb = tcallbacks.EvalMapCallback(model, str(anno), str(img_dir),
                                    str(work), every=1, verbose=0)
    cb(trainer, {"epoch": 0})
    assert model._trainer is None
    for a, b in zip(ttrain.leaves(model.params),
                    ttrain.leaves(trainer.params)):
        assert torch.equal(a, b) and a is not b
    with torch.no_grad():                 # a later step moves the trainer
        trainer.params["convs"][0]["w"].add_(1.0)
    assert not torch.equal(model.params["convs"][0]["w"],
                           trainer.params["convs"][0]["w"])

    direct = tmp_path / "direct"
    model.export_gt(str(anno), str(direct / "gt"))
    model.export_prediction(str(anno), str(direct / "pred"), str(img_dir),
                            verbose=False)
    scores = model.eval_map(str(direct / "gt"), str(direct / "pred"),
                            str(direct / "json"), str(direct / "result"),
                            plot=False, verbose=False)
    assert cb.history == [{"epoch": 0, **scores}]
    n_det = 0
    for ours, theirs in (("ground_truth", "gt"), ("pred_result", "pred")):
        names = sorted(os.listdir(direct / theirs))
        assert sorted(os.listdir(work / ours)) == names == ["e0.txt",
                                                            "e1.txt"]
        for name in names:
            text = (work / ours / name).read_bytes()
            assert text == (direct / theirs / name).read_bytes()
            n_det += len(text.splitlines()) if ours == "pred_result" else 0
    assert n_det > 0
    assert ((work / "result" / "output.txt").read_bytes()
            == (direct / "result" / "output.txt").read_bytes())
    # every=2 skips epoch 0
    skip = tcallbacks.EvalMapCallback(model, str(anno), str(img_dir),
                                      str(tmp_path / "skip"), every=2,
                                      verbose=0)
    skip(trainer, {"epoch": 0})
    assert skip.history == [] and not (tmp_path / "skip").exists()


class _OneBatch:
    """A generator of one fixed batch per epoch."""

    def __init__(self, batch):
        self.batch = batch

    def __len__(self):
        return 1

    def get_batch(self, i):
        return self.batch

    def on_epoch_end(self):
        pass


def test_fit_resumes_at_the_next_epoch(tmp_path):
    """fit(epochs=1, resume_dir) with the cosine and checkpoint callbacks,
    then fit(epochs=2) of a new trainer on the same directory: it trains
    only epoch 1, continues global_step, and keeps the LR the callback set
    for epoch 1 (the checkpoint holds it; no LR callback now)."""
    resume = str(tmp_path / "resume")
    cosine = tcallbacks.CosineAnnealingScheduler(1e-3, 1e-5, 4)
    ck = tcallbacks.CheckpointCallback(str(tmp_path / "ck_{epoch}.npz"))
    first = ttrain.Trainer(YoloConfig(**KW), C, *torch_params(C),
                           device="cpu")
    history = first.fit(_OneBatch(train_batch(0, 2, C)[0]), epochs=1,
                        callbacks=[cosine, ck], verbose=False,
                        resume_dir=resume)
    assert [h["epoch"] for h in history] == [0]
    assert cosine.history == [cosine.lr(0)]
    assert os.listdir(tmp_path / "resume") == ["latest.npz"]
    assert os.path.exists(tmp_path / "ck_0.npz")

    second = ttrain.Trainer(YoloConfig(**KW), C, *torch_params(C),
                            device="cpu")
    seen = []
    history = second.fit(
        _OneBatch(train_batch(1, 2, C)[0]), epochs=2, verbose=False,
        resume_dir=resume,
        callbacks=[lambda t, e: seen.append((e["epoch"], t.learning_rate))])
    assert [h["epoch"] for h in history] == [1]
    assert np.isfinite(history[0]["loss"])
    assert second.global_step == 2
    assert seen == [(1, float(np.float32(cosine.lr(1))))]
    with np.load(os.path.join(resume, "latest.npz")) as data:
        assert int(data["meta/step"]) == 2
        assert json.loads(data["meta/extra_json"].tobytes()) == {"epoch": 1}
