"""Gradient accumulation over a ragged batch: ``Trainer.train_step`` with
``grad_accum_steps=2`` on 5 samples (padded to 6 with a validity mask, two
micro-batches of 3, the second with one padded sample), in the port and in
the JAX package, from the same parameters.

Tolerances (see tests/test_torch_train_step.py for why float32 allows no
tighter ones at this size): the loss metric rel 1e-4, BN moving statistics
1e-4 absolute, and the Adam step agreement of
``_torch_parity.adam_step_agreement`` (90% of entries to 1e-2 * lr, none
beyond 2 * lr).
"""

import copy

import jax
import numpy as np
import optax

from _torch_parity import (IMG, SHALLOW, adam_step_agreement, torch_params,
                           train_batch, well_conditioned)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=6, csp_repeats=SHALLOW,
          learning_rate=1e-3, grad_accum_steps=2)


def test_accumulated_masked_step_matches_jax():
    """The JAX side: the JAX package's pad and chunk (``pad_mask_batch``,
    ``chunk_batch``), its gradient core on each masked micro-batch in turn
    (the BN state carried from one to the next), the combination
    ``_accumulated`` makes (each micro-gradient and metric weighted by its
    valid count), then its optax update.  ``_accumulated`` runs the same
    core under ``lax.scan``; calling the core per micro-batch keeps this
    test to one compile.  The port's side is ``Trainer.train_step``."""
    params, state = well_conditioned(C)
    batch, _ = train_batch(7, 5, C)
    jcfg = JaxConfig(**KW)
    stacked = jtrain.chunk_batch(jtrain.pad_mask_batch(batch, 6), 2)
    core = jax.jit(jtrain._make_grad_and_metrics(C, jcfg))
    gsum, msum, wsum, st_j = None, None, 0.0, state
    for i in range(2):
        micro = jax.tree.map(lambda x: x[i], stacked)
        g, st_j, m = core(params, st_j, micro)
        w = float(np.sum(micro["mask"]))
        scaled = jax.tree.map(lambda x: w * np.asarray(x), (g, m))
        gsum, msum = scaled if gsum is None else jax.tree.map(
            np.add, (gsum, msum), scaled)
        wsum += w
    g_j, m_j = jax.tree.map(lambda x: x / wsum, (gsum, msum))
    opt = jtrain.make_optimizer(jcfg)
    p_j = jax.jit(lambda p, g: optax.apply_updates(
        p, opt.update(g, opt.init(p), p)[0]))(params, g_j)

    tp, ts = torch_params(C)
    tt = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu")
    m_t = tt.train_step(batch)
    np.testing.assert_allclose(float(m_t["loss"]), float(m_j["loss"]),
                               rtol=1e-4)
    for a, b in zip(tt.state["bn"], st_j["bn"]):
        if b is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=0, atol=1e-4)
    frac, worst = adam_step_agreement(
        copy.deepcopy(tp), jax.tree.map(np.asarray, p_j), tt.params,
        KW["learning_rate"])
    assert frac >= 0.9, frac
    assert worst <= 2.0 + 1e-3, worst
    assert tt.global_step == 1


def test_accumulation_rejects_a_batch_size_it_cannot_split():
    tp, ts = torch_params(C)
    cfg = YoloConfig(**dict(KW, batch_size=5))
    tt = ttrain.Trainer(cfg, C, tp, ts, device="cpu")
    batch, _ = train_batch(8, 5, C)
    try:
        tt.train_step(batch)
    except ValueError as e:
        assert "grad_accum_steps" in str(e)
    else:
        raise AssertionError("a batch_size of 5 split in 2 did not raise")
