"""The port's training pieces that need no JAX model compile: the
optimizers against optax on the same vectors, the batch helpers and the
LR schedule against the JAX package's, and the port's own invariants
(pallas_wgrad, the uint8 wire, SAT, a ragged eval batch, the mutable LR).

Tolerances: the optimizers do the same float32 arithmetic as optax up to
the order of a few operations (torch.optim.Adam divides by sqrt of the
bias correction where optax divides nu first): rtol 1e-6 and atol 3e-7 (a
few float32 ulps of O(1) parameters) after three steps.  ``pallas_wgrad=True`` against ``False`` changes only
the weight-gradient kernel: the same loss and BN state exactly, and each
gradient leaf within rel-RMS 1e-4 (the contract of
tests/test_wgrad_pallas.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, conv_leaves, rel_rms, to_torch,
                           torch_params, train_batch)
from yolov4tpu import train as jtrain
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW)


def _vectors(seed=0, n=3):
    rng = np.random.default_rng(seed)
    params = [rng.normal(0, 1, (5, 7)).astype(np.float32),
              rng.normal(0, 1, (11,)).astype(np.float32)]
    grads = [[rng.normal(0, s, p.shape).astype(np.float32) for p in params]
             for s in (1.0, 1e-3, 10.0)[:n]]
    return params, grads


def _optax_run(opt, params, grads, lrs=None):
    state = opt.init(params)
    for i, g in enumerate(grads):
        if lrs is not None:
            state.hyperparams["learning_rate"] = jnp.float32(lrs[i])
        upd, state = opt.update(g, state, params)
        params = optax.apply_updates(params, upd)
    return [np.asarray(p) for p in params]


def _port_run(make, params, grads, set_lr=None, lrs=None):
    tensors = [torch.from_numpy(p.copy()) for p in params]
    opt = make(tensors)
    for i, g in enumerate(grads):
        if lrs is not None:
            set_lr(opt, lrs[i])
        opt.step([torch.from_numpy(x) for x in g])
    return [t.numpy() for t in tensors]


def test_adam_with_mutable_lr_matches_optax():
    params, grads = _vectors()
    lrs = [1e-3, 5e-4, 2e-3]
    want = _optax_run(optax.inject_hyperparams(optax.adam)(learning_rate=1e-3),
                      params, grads, lrs)

    def set_lr(opt, lr):
        opt.opt.param_groups[0]["lr"] = lr
    got = _port_run(lambda t: ttrain.Adam(t, 1e-3), params, grads, set_lr, lrs)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=3e-7)


@pytest.mark.parametrize("fused", [False, True])
def test_scheduled_adam_matches_optax(fused):
    """The schedule is read at the pre-increment step count, as optax reads
    it; the fused flat-vector Adam gives the same update."""
    params, grads = _vectors(1)
    jsched = jtrain.cosine_annealing_schedule(1e-2, 1e-4, 2, 1)
    tsched = ttrain.cosine_annealing_schedule(1e-2, 1e-4, 2, 1)
    for step in range(5):
        np.testing.assert_allclose(tsched(step), float(jsched(step)),
                                   rtol=1e-6)
    if fused:
        want = _optax_run(jtrain.fused_adam(jsched), params, grads)
        got = _port_run(lambda t: ttrain.fused_adam(t, tsched), params, grads)
    else:
        want = _optax_run(optax.adam(jsched), params, grads)
        got = _port_run(lambda t: ttrain.Adam(t, 1e-3, tsched), params, grads)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=3e-7)


def test_batch_helpers_match_jax():
    for b in range(1, 200):
        assert ttrain.aligned_batch(b) == jtrain.aligned_batch(b)
        assert ttrain.aligned_size(b) == jtrain.aligned_size(b)
        assert ttrain.decompose_batch(b) == jtrain.decompose_batch(b)
    batch, _ = train_batch(0, 3, C)
    want = jax.tree.map(np.asarray, jtrain.pad_mask_batch(batch, 4))
    got = ttrain.pad_mask_batch(to_torch(batch), 4)
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["mask"].numpy(), want["mask"])
    chunked = ttrain.chunk_batch(got, 2)
    want_chunked = jtrain.chunk_batch(want, 2)
    for key in want:
        for tree, ref in ((got, want), (chunked, want_chunked)):
            for g, w in zip(ttrain.leaves(tree[key]),
                            jax.tree.leaves(ref[key])):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError):
        ttrain.chunk_batch(to_torch(batch), 2)


def test_pallas_wgrad_changes_only_the_weight_gradient_kernel():
    batch, _ = train_batch(2, 2, C)
    tp, ts = torch_params(C)
    outs = [ttrain._make_grad_and_metrics(
        C, YoloConfig(**KW, pallas_wgrad=flag))(tp, ts, to_torch(batch))
        for flag in (False, True)]
    (g0, st0, m0), (g1, st1, m1) = outs
    assert float(m1["loss"]) == float(m0["loss"])
    for a, b in zip(st0["bn"], st1["bn"]):
        if a is not None:
            for k in ("mean", "var"):
                np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    for (i, k, a), (_, _, b) in zip(conv_leaves(g0), conv_leaves(g1)):
        assert rel_rms(b, a) < 1e-4, (i, k)


def test_uint8_wire_and_sat():
    """The uint8 image wire divides by 255 on the device (the same float32
    batch as a host /255); self-adversarial training (sat_epsilon) takes one
    signed-gradient step on the images first and gives a finite loss above
    the clean one's."""
    batch, _ = train_batch(3, 2, C)
    u8 = np.clip(np.rint(batch["image"] * 255), 0, 255).astype(np.uint8)
    tp, ts = torch_params(C)
    core = ttrain._make_grad_and_metrics(C, YoloConfig(**KW))
    _, _, m_u8 = core(tp, ts, to_torch(dict(batch, image=u8)))
    _, _, m_f = core(tp, ts, to_torch(dict(batch, image=u8 / np.float32(255))))
    assert float(m_u8["loss"]) == float(m_f["loss"])
    sat = ttrain._make_grad_and_metrics(C, YoloConfig(**KW, sat_epsilon=0.01))
    g, _, m = sat(tp, ts, to_torch(batch))
    _, _, m_clean = core(tp, ts, to_torch(batch))
    assert np.isfinite(float(m["loss"]))
    assert float(m["loss"]) > float(m_clean["loss"])
    assert all(np.isfinite(t).all() for _, _, t in conv_leaves(g))


def test_device_encoded_batch_gives_the_host_encoded_step():
    """encode_on_device: a {'image', 'raw_boxes'} batch is encoded inside
    the core (encode_labels_torch, bit-identical to the host encoder), so
    the loss and gradients equal the host-encoded batch's exactly."""
    batch, raw = train_batch(4, 2, C)
    tp, ts = torch_params(C)
    host = ttrain._make_grad_and_metrics(C, YoloConfig(**KW))(
        tp, ts, to_torch(batch))
    dev = ttrain._make_grad_and_metrics(
        C, YoloConfig(**KW, encode_on_device=True))(
            tp, ts, to_torch({"image": batch["image"], "raw_boxes": raw}))
    assert float(dev[2]["loss"]) == float(host[2]["loss"])
    for (_, _, a), (_, _, b) in zip(conv_leaves(host[0]), conv_leaves(dev[0])):
        np.testing.assert_array_equal(a, b)


def test_trainer_lr_and_ragged_eval():
    tp, ts = torch_params(C)
    trainer = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu")
    assert trainer.learning_rate == pytest.approx(1e-4)
    trainer.set_learning_rate(3e-4)
    assert trainer.learning_rate == pytest.approx(3e-4)
    assert trainer.params["convs"][0]["w"] is not tp["convs"][0]["w"]
    sched = ttrain.Trainer(YoloConfig(**KW), C, tp, ts, device="cpu",
                           schedule=lambda step: 1e-3)
    with pytest.raises(RuntimeError, match="mutable"):
        sched.learning_rate
    # A ragged eval batch of 3 (padded to 4 with a mask) gives the loss of
    # its 3 samples: BN runs on the moving statistics, so padding is exact.
    batch, _ = train_batch(5, 3, C)
    ragged = float(trainer.eval_step(batch))
    per = [float(trainer.eval_step(jax.tree.map(lambda x: x[i:i + 1], batch)))
           for i in range(3)]
    assert ragged == pytest.approx(np.mean(per), rel=1e-5)
