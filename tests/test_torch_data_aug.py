"""The port's ``DataGenerator`` on its Python path (``use_native=False``)
against the JAX package's, option by option: with the same seed the
batches are equal bit for bit over two epochs (the same per-sample seeds
from one sequential draw, the same draws in the same order, the same cv2
calls, the same host encoder).  Also: the worker pool's batches do not
depend on its size, ``close`` is idempotent, and bad multi-scale bounds
raise.
"""

import numpy as np
import pytest

from test_torch_data import write_dataset
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.data.pipeline import DataGenerator as JaxGenerator
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data import pipeline as tpipe
from yolov4tpu_torch.data.pipeline import DataGenerator

IMG = 64


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("aug_data")
    return folder, write_dataset(folder, n=6, seed=4)


def assert_batches_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for key in want:
        gs = got[key] if key == "labels" else [got[key]]
        ws = want[key] if key == "labels" else [want[key]]
        assert len(gs) == len(ws)
        for g, w in zip(gs, ws):
            assert g.dtype == w.dtype and g.shape == w.shape, key
            np.testing.assert_array_equal(g, w, err_msg=key)


def pair(dataset, tiny_classes, workers=(2, 1), use_native=False,
         seed=3, gen_kw=None, **cfg):
    """(port generator, JAX generator) over the same lines and seed."""
    folder, lines = dataset
    kw = dict(img_size=(IMG, IMG, 3), **{"batch_size": 2, **cfg})
    gen_kw = gen_kw or {}
    tgen = DataGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                         config=YoloConfig(num_workers=workers[0], **kw),
                         seed=seed, use_native=use_native, **gen_kw)
    jgen = JaxGenerator(lines, tiny_classes, str(folder), max_boxes=10,
                        config=JaxConfig(num_workers=workers[1], **kw),
                        seed=seed, use_native=use_native, **gen_kw)
    return tgen, jgen


def run_epochs(tgen, jgen, epochs=2):
    sizes = []
    for _ in range(epochs):
        assert len(tgen) == len(jgen)
        for i in range(len(tgen)):
            got, want = tgen.get_batch(i), jgen.get_batch(i)
            assert_batches_equal(got, want)
            sizes.append(got["image"].shape[1])
        tgen.on_epoch_end()
        jgen.on_epoch_end()
    return sizes


OPTIONS = {
    "mosaic": dict(use_mosaic=True),
    "cutmix": dict(use_cutmix=True),
    "hflip": dict(use_hflip=True),
    "jitter": dict(use_color_jitter=True),
    "letterbox": dict(letterbox=True),
    "multi-scale": dict(multi_scale=(32, 96), multi_scale_interval=1),
    "mosaic+cutmix+hflip+jitter": dict(use_mosaic=True, use_cutmix=True,
                                       use_hflip=True, use_color_jitter=True),
    "letterbox+jitter": dict(letterbox=True, use_color_jitter=True),
    "letterbox+hflip+mosaic": dict(letterbox=True, use_hflip=True,
                                   use_mosaic=True),
    "multi-scale+encode_on_device+uint8": dict(
        multi_scale=(32, 96), multi_scale_interval=1, encode_on_device=True,
        transfer_uint8=True, use_hflip=True, use_color_jitter=True),
    "multi-scale interval 2+mosaic": dict(
        multi_scale=(32, 128), multi_scale_interval=2, use_mosaic=True),
}


@pytest.mark.parametrize("name", sorted(OPTIONS))
def test_python_path_equals_jax(dataset, tiny_classes, name):
    tgen, jgen = pair(dataset, tiny_classes, **OPTIONS[name])
    with tgen:
        sizes = run_epochs(tgen, jgen)
    jgen.close()
    if "multi_scale" in OPTIONS[name]:
        assert len(set(sizes)) > 1, sizes
        assert tgen.target_img_size == jgen.target_img_size


def test_constructor_mosaic_and_cutmix_flags_equal_jax(dataset,
                                                       tiny_classes):
    tgen, jgen = pair(dataset, tiny_classes,
                      gen_kw=dict(mosaic=True, cutmix=True), use_hflip=True)
    assert tgen.mosaic and tgen.cutmix
    run_epochs(tgen, jgen, epochs=1)


def test_getitem_tuple_equals_jax(dataset, tiny_classes):
    tgen, jgen = pair(dataset, tiny_classes, use_mosaic=True,
                      encode_on_device=True)
    x, y = tgen[1]
    xj, yj = jgen[1]
    assert len(x) == len(xj) == 5
    for g, w in zip(x, xj):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(y, yj)


def test_pool_batches_do_not_depend_on_its_size(dataset, tiny_classes):
    """1 worker (no pool) and 4 workers give the same batches, the pool is
    made at the first batch of more than one sample, and both equal the
    JAX package's."""
    aug = dict(use_mosaic=True, use_hflip=True, use_color_jitter=True,
               batch_size=4)
    one, jgen = pair(dataset, tiny_classes, workers=(1, 1), **aug)
    four, _ = pair(dataset, tiny_classes, workers=(4, 1), **aug)
    assert one._pool is None and four._pool is None
    for i in range(len(one)):
        b1, b4, bj = one.get_batch(i), four.get_batch(i), jgen.get_batch(i)
        assert_batches_equal(b4, b1)
        assert_batches_equal(b1, bj)
    assert one._pool is None and four._pool is not None
    four.close()


def test_close_is_idempotent_and_the_pool_comes_back(dataset, tiny_classes):
    tgen, _ = pair(dataset, tiny_classes, workers=(3, 1), use_hflip=True)
    before = tpipe.PYTHON_BATCHES
    first = tgen.get_batch(0)["image"]
    assert tpipe.PYTHON_BATCHES == before + 1
    pool = tgen._pool
    assert pool is not None
    tgen.close()
    tgen.close()
    assert tgen._pool is None
    with pytest.raises(RuntimeError):      # the old pool was shut down
        pool.submit(int)
    again = tgen.get_batch(0)["image"]     # a new pool on demand
    assert again.shape == first.shape
    assert tgen._pool is not None and tgen._pool is not pool
    with tgen as same:
        assert same is tgen
    assert tgen._pool is None


@pytest.mark.parametrize("bounds", [(32, 100), (40, 96), (96, 64)])
def test_bad_multi_scale_bounds_raise(dataset, tiny_classes, bounds):
    folder, lines = dataset
    with pytest.raises(ValueError, match="multiples of 32"):
        DataGenerator(lines, tiny_classes, str(folder), use_native=False,
                      config=YoloConfig(img_size=(IMG, IMG, 3),
                                        multi_scale=bounds, num_workers=1))
