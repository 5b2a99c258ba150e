"""Multi-scale training in the port: ``Trainer.fit`` over a ``DataGenerator``
whose square size is redrawn every batch (``multi_scale=(64, 96)``,
``multi_scale_interval=1``), through the prefetch thread's placement, on
the host encoder and on ``encode_on_device`` with the uint8 wire; and
``train_step`` at two sizes on the chunked ragged path.  The counterpart
of the JAX package's ``test_train_step_handles_multiple_sizes``
(tests/test_pipeline.py).

Tolerance: the first step's loss (96 px, from the same parameters on the
same batch) against the JAX package's gradient core as
tests/test_torch_train_step.py holds it: rel 1e-5 plus twice the JAX
loss's own movement under a 1e-6 relative perturbation of the images.  The
movement is the largest over three perturbations: on this batch of real
boxes the confidence term is chaotic, and one perturbation moved the JAX
loss by a relative 2.0e-05 where another moved it by 1.6e-04 (measured).
"""

import functools

import jax
import numpy as np
import pytest

from _torch_parity import SHALLOW, torch_params, well_conditioned
from test_torch_data import write_dataset
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.data.pipeline import DataGenerator as JaxGenerator
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.pipeline import DataGenerator

C = 3
# Seed 7 draws the sizes 96 and 64 for the two batches of the first epoch:
# the first step runs at 96 px.
SEED = 7
KW = dict(img_size=(64, 64, 3), batch_size=2, csp_repeats=SHALLOW,
          learning_rate=1e-3, multi_scale=(64, 96), multi_scale_interval=1,
          num_workers=1)


@functools.lru_cache(maxsize=None)
def _jax_core():
    return jax.jit(jtrain._make_grad_and_metrics(C, JaxConfig(**KW)))


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    folder = tmp_path_factory.mktemp("multiscale")
    return folder, write_dataset(folder, n=4, seed=1)


def recording(trainer):
    """Wrap the trainer's train_step to record (size, device, loss)."""
    steps = []
    inner = trainer.train_step

    def step(batch):
        metrics = inner(batch)
        image = batch["image"]
        steps.append((int(image.shape[1]), str(image.dtype),
                      float(metrics["loss"])))
        return metrics

    trainer.train_step = step
    return steps


def fit_one_epoch(dataset, tiny_classes, **wire):
    """A shallow port trainer's fit over the multi-scale generator: the
    recorded (size, image dtype, loss) of its two steps."""
    folder, lines = dataset
    cfg = YoloConfig(**KW, **wire)
    gen = DataGenerator(lines, tiny_classes, str(folder), config=cfg,
                        seed=SEED, use_native=False)
    trainer = ttrain.Trainer(cfg, C, *torch_params(C), device="cpu")
    steps = recording(trainer)
    history = trainer.fit(gen, epochs=1, verbose=False)
    assert [s for s, _, _ in steps] == [96, 64]
    assert all(np.isfinite(loss) for _, _, loss in steps)
    assert all(np.isfinite(h["loss"]) for h in history)
    assert trainer.global_step == 2
    return steps


def test_fit_on_the_host_encoder_and_the_first_step_matches_jax(
        dataset, tiny_classes):
    folder, lines = dataset
    jgen = JaxGenerator(lines, tiny_classes, str(folder),
                        config=JaxConfig(**KW), seed=SEED, use_native=False)
    batch = jgen.get_batch(0)
    assert batch["image"].shape[1:3] == (96, 96)
    params, state = well_conditioned(C)
    loss_j = float(_jax_core()(params, state, batch)[2]["loss"])
    moved = 0.0
    for seed in (1, 2, 3):
        noise = np.random.default_rng(seed).normal(size=batch["image"].shape)
        image = (batch["image"] * (1 + 1e-6 * noise)).astype(np.float32)
        loss_p = float(_jax_core()(params, state,
                                   dict(batch, image=image))[2]["loss"])
        moved = max(moved, abs(loss_p - loss_j) / loss_j)

    steps = fit_one_epoch(dataset, tiny_classes)
    assert {d for _, d, _ in steps} == {"torch.float32"}
    loss_t = steps[0][2]
    assert abs(loss_t - loss_j) / loss_j <= 1e-5 + 2 * moved


def test_fit_encodes_on_device_from_the_uint8_wire(dataset, tiny_classes):
    steps = fit_one_epoch(dataset, tiny_classes, encode_on_device=True,
                          transfer_uint8=True)
    assert {d for _, d, _ in steps} == {"torch.uint8"}


def test_train_step_takes_two_sizes_on_the_chunked_path():
    """A 33-sample batch is not aligned, so train_step runs it as aligned
    chunks; at 32 and then 64 px both steps are finite."""
    cfg = YoloConfig(img_size=(64, 64, 3), batch_size=33,
                     csp_repeats=SHALLOW)
    trainer = ttrain.Trainer(cfg, C, *torch_params(C), device="cpu")
    rng = np.random.default_rng(0)
    for s in (32, 64):
        boxes = np.zeros((33, 100, 5), np.float32)
        boxes[:, 0] = [4, 4, s - 4, s - 4, 1]
        batch = {"image": rng.uniform(0, 1, (33, s, s, 3)).astype(np.float32),
                 "raw_boxes": boxes}
        metrics = trainer.train_step(batch)
        assert np.isfinite(float(metrics["loss"]))
    assert trainer._chunk_grad is not None and trainer.global_step == 2
