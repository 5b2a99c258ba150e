"""The port's DataGenerator (yolov4tpu_torch.data.pipeline, python path)
against the JAX package's ``DataGenerator(use_native=False)``: with the
same seed the batches are equal bit for bit (the same cv2 decode and
resize, the same per-sample seeds drawn in one sequential draw, the same
host encoder).  Also: ``prefetch`` yields the same batches, and the facade
trains and serves on the CPU.  The augmentations are in
test_torch_data_aug.py, the native ingest in test_torch_native.py.
"""

import cv2
import numpy as np
import pytest
import torch

from _torch_parity import SHALLOW
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.data.pipeline import DataGenerator as JaxGenerator
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.pipeline import DataGenerator, prefetch

IMG = 64


def write_dataset(folder, n=5, seed=0):
    """n JPEGs of different sizes with 1-3 boxes each -> annotation lines
    ("name x1,y1,x2,y2,c ...") as the reference's files hold them."""
    rng = np.random.default_rng(seed)
    lines = []
    for i in range(n):
        h, w = int(rng.integers(40, 90)), int(rng.integers(40, 90))
        img = rng.integers(0, 255, (h, w, 3), dtype=np.uint8)
        cv2.imwrite(str(folder / f"img{i}.jpg"), img)
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
            x2 = int(rng.integers(x1 + 4, w))
            y2 = int(rng.integers(y1 + 4, h))
            boxes.append(f"{x1},{y1},{x2},{y2},{int(rng.integers(0, 3))}")
        lines.append(f"img{i}.jpg " + " ".join(boxes))
    return lines


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("data")
    return folder, write_dataset(folder)


@pytest.mark.parametrize("opts", [{}, {"encode_on_device": True},
                                  {"transfer_uint8": True}])
def test_batches_equal_jax_bit_for_bit(dataset, tiny_classes, opts):
    folder, lines = dataset
    kw = dict(img_size=(IMG, IMG, 3), batch_size=2, **opts)
    jgen = JaxGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                        config=JaxConfig(**kw), seed=3, use_native=False)
    tgen = DataGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                         config=YoloConfig(**kw), seed=3, use_native=False)
    assert len(tgen) == len(jgen) == 3
    for _ in range(2):                      # two epochs: the shuffle too
        for i in range(len(tgen)):
            got, want = tgen.get_batch(i), jgen.get_batch(i)
            assert sorted(got) == sorted(want)
            for key in want:
                for g, w in zip(np.atleast_1d(got[key]) if key != "labels"
                                else got[key],
                                np.atleast_1d(want[key]) if key != "labels"
                                else want[key]):
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
        tgen.on_epoch_end()
        jgen.on_epoch_end()
    x, y = tgen[0]
    xj, yj = jgen[0]
    for g, w in zip(x, xj):
        np.testing.assert_array_equal(g, w)


def test_prefetch_yields_the_generators_batches(dataset, tiny_classes):
    folder, lines = dataset
    cfg = YoloConfig(img_size=(IMG, IMG, 3), batch_size=2)
    a = DataGenerator(lines, tiny_classes, str(folder), config=cfg, seed=1)
    b = DataGenerator(lines, tiny_classes, str(folder), config=cfg, seed=1)
    got = list(prefetch(a, epochs=2))
    want = [b.get_batch(i) for i in range(len(b))]
    b.on_epoch_end()
    want += [b.get_batch(i) for i in range(len(b))]
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["image"], w["image"])
        np.testing.assert_array_equal(g["boxes"], w["boxes"])


def test_facade_fit_then_predict_on_cpu(dataset, tiny_classes):
    """Yolov4.fit trains on the facade's device (with a validation
    generator of one ragged batch, which eval_step pads and masks), then
    refolds so predict_batch serves the trained weights."""
    folder, lines = dataset
    cfg = YoloConfig(img_size=(IMG, IMG, 3), batch_size=2,
                     csp_repeats=SHALLOW, learning_rate=1e-3)
    model = tapi.Yolov4(None, tiny_classes, config=cfg, device="cpu")
    probe = torch.full((1, IMG, IMG, 3), 0.5)
    before = model._raw(probe)
    gen = DataGenerator(lines[:4], tiny_classes, str(folder), config=cfg,
                        seed=0)
    val = DataGenerator(lines[4:], tiny_classes, str(folder), config=cfg,
                        shuffle=False)
    history = model.fit(gen, epochs=2, val_data_gen=val, verbose=False)
    assert [h["epoch"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"])
               for h in history)
    trainer = model.trainer()
    assert trainer.global_step == 4
    assert trainer.params["convs"][0]["w"].device.type == "cpu"
    np.testing.assert_array_equal(model.params["convs"][0]["w"].numpy(),
                                  trainer.params["convs"][0]["w"].numpy())
    out = model.predict_batch(np.zeros((1, IMG, IMG, 3), np.float32))
    assert all(torch.isfinite(o.float()).all() for o in out)
    after = model._raw(probe)
    assert all(not torch.equal(a, b) for a, b in zip(before, after))
