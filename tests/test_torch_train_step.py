"""The port's gradient core (``train._make_grad_and_metrics``) against the
JAX package's under ``jax.jit``, on one batch, with ``pallas_wgrad`` off
(tests/test_torch_train_pallas.py has it on).

Tolerances.  The loss and its gradient run through 73 training-mode
BatchNorms whose moments are E[y^2] - E[y]^2 in float32 over as few as 8
samples per channel at this test size (64 px, B=2).  That forward is
sensitive to rounding: perturbing the images by a relative 1e-7 (one
float32 ulp) moves the JAX package's own gradients by up to 13% rel-RMS in
the deep layers (measured), and the port rounds differently at every layer
(another conv library, another summation order).  So each quantity is held
to a fixed tolerance plus twice the JAX package's own movement under a
1e-6 relative perturbation of the images, measured in the test:
  - loss: rel 1e-5 + 2x its movement;
  - each gradient leaf: rel-RMS 1e-4 + 2x its movement.  Leaves the chaos
    does not reach (the heads: movement ~1e-5) are held near 1e-4; a
    semantic fault moves a leaf by far more than its own float32 noise;
  - BN moving statistics (1% of a batch statistic): 1e-4 absolute.
One Adam step: the JAX package's ``make_train_step`` is this core followed
by the optax update and ``optax.apply_updates``; composed here from the
core's gradients, against the port's ``make_train_step``.  Adam's first
step moves every entry by +-lr wherever |g| >> eps, so the two updates
agree to 1e-2 * lr wherever the gradients agree in sign, and differ by at
most 2 * lr where float32 noise flips the sign of an entry near zero: at
least 90% of all entries agree, none differs by more than 2 * lr.
"""

import copy
import functools

import jax
import numpy as np
import optax

from _torch_parity import (IMG, SHALLOW, adam_step_agreement, conv_leaves,
                           rel_rms, to_torch, torch_params, train_batch,
                           well_conditioned)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW,
          learning_rate=1e-3)


@functools.lru_cache(maxsize=None)
def _jax_core():
    return jax.jit(jtrain._make_grad_and_metrics(C, JaxConfig(**KW)))


def _perturbed(batch, eps=1e-6, seed=1):
    rng = np.random.default_rng(seed)
    img = batch["image"] * (1 + eps * rng.normal(size=batch["image"].shape))
    return dict(batch, image=img.astype(np.float32))


def test_grad_core_matches_jax():
    params, state = well_conditioned(C)
    batch, _ = train_batch(0, 2, C)
    g_j, st_j, m_j = _jax_core()(params, state, batch)
    g_p, _, m_p = _jax_core()(params, state, _perturbed(batch))
    tp, ts = torch_params(C)
    g_t, st_t, m_t = ttrain._make_grad_and_metrics(C, YoloConfig(**KW))(
        tp, ts, to_torch(batch))

    loss_j, loss_t = float(m_j["loss"]), float(m_t["loss"])
    moved = abs(float(m_p["loss"]) - loss_j) / loss_j
    assert abs(loss_t - loss_j) / loss_j <= 1e-5 + 2 * moved
    for k in ("box", "conf", "prob"):
        np.testing.assert_allclose(float(m_t[k]), float(m_j[k]), rtol=1e-3)
    for a, b in zip(st_t["bn"], st_j["bn"]):
        if b is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                           rtol=0, atol=1e-4)
    worst = []
    for (i, k, t), (_, _, j), (_, _, p) in zip(
            conv_leaves(g_t), conv_leaves(g_j), conv_leaves(g_p)):
        assert t.shape == j.shape and np.isfinite(t).all()
        err, noise = rel_rms(t, j), rel_rms(p, j)
        assert err <= 1e-4 + 2 * noise, (i, k, err, noise)
        worst.append(err)
    # The heads (last conv of each scale) see no BatchNorm downstream.
    assert max(worst[-2:]) < 1e-3


def test_one_adam_step_matches_make_train_step_with_optax():
    params, state = well_conditioned(C)
    batch, _ = train_batch(0, 2, C)
    g_j, _, _ = _jax_core()(params, state, batch)
    opt = jtrain.make_optimizer(JaxConfig(**KW))

    @jax.jit
    def apply_adam(params, grads):
        updates, _ = opt.update(grads, opt.init(params), params)
        return optax.apply_updates(params, updates)
    p_j = apply_adam(params, g_j)

    tp = ttrain.tree_map(lambda t: t.clone(), torch_params(C)[0])
    ts = torch_params(C)[1]
    opt_t = ttrain.make_optimizer(YoloConfig(**KW), ttrain.leaves(tp))
    st_t, m_t = ttrain.make_train_step(C, YoloConfig(**KW), opt_t)(
        tp, ts, to_torch(batch))
    assert np.isfinite(float(m_t["loss"])) and opt_t.count == 1
    frac, worst = adam_step_agreement(
        copy.deepcopy(torch_params(C)[0]), jax.tree.map(np.asarray, p_j), tp,
        KW["learning_rate"])
    assert frac >= 0.9, frac
    assert worst <= 2.0 + 1e-3, worst
