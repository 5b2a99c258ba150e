"""``Trainer._chunked_step`` — one optimizer step over a batch split into
chunks, each with its own BN batch statistics, gradients, BN states and
metrics combined by valid counts — in the port and in the JAX package.

The JAX package splits a non-aligned batch (e.g. 33 = 32 + 1) into chunks
of different sizes, each a compiled program.  To compare the combination
with one compile, both packages' ``decompose_batch`` are patched to split a
batch of 4 into two chunks of 2; ``decompose_batch`` itself is compared for
every batch size in tests/test_torch_train_port.py.

Tolerances as in tests/test_torch_train_ragged.py; the loss's box, conf
and prob terms to rel 1e-3.
"""

import copy

import jax
import numpy as np

from _torch_parity import (IMG, SHALLOW, adam_step_agreement, torch_params,
                           train_batch, well_conditioned)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=4, csp_repeats=SHALLOW,
          learning_rate=1e-3)


def test_chunked_step_matches_jax(monkeypatch):
    def two_chunks(b):
        assert b == 4
        return [(2, 2), (2, 2)]
    monkeypatch.setattr(jtrain, "decompose_batch", two_chunks)
    monkeypatch.setattr(ttrain, "decompose_batch", two_chunks)
    params, state = well_conditioned(C)
    batch, _ = train_batch(9, 4, C)
    jt = jtrain.Trainer(JaxConfig(**KW), C, params, state)
    m_j = jt._chunked_step(jax.device_put(batch))
    tp, ts = torch_params(C)
    tt = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu")
    m_t = tt._chunked_step(ttrain.tree_map(np.asarray, batch))
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-4)
    for k in ("box", "conf", "prob"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3)
    for a, b in zip(tt.state["bn"], jt.state["bn"]):
        if b is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=0, atol=1e-4)
    frac, worst = adam_step_agreement(
        copy.deepcopy(tp), jax.tree.map(np.asarray, jt.params), tt.params,
        KW["learning_rate"])
    assert frac >= 0.9, frac
    assert worst <= 2.0 + 1e-3, worst


def test_non_aligned_batch_takes_the_chunked_path(monkeypatch):
    """A batch of 33 is not aligned: train_step splits it 32 + 1 and never
    drops a sample."""
    seen = []
    tp, ts = torch_params(C)
    tt = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu")
    monkeypatch.setattr(tt, "_chunked_step",
                        lambda b: seen.append(ttrain._batch_size(b)) or {})
    batch = {"image": np.zeros((33, IMG, IMG, 3), np.float32),
             "raw_boxes": np.zeros((33, 100, 5), np.float32)}
    tt.train_step(batch)
    assert seen == [33]
    assert ttrain.decompose_batch(33) == [(32, 32), (1, 1)]
