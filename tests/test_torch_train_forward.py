"""The port's training forward (``network.apply(train=True)``) against the
JAX package's, on the same numpy inputs.

One conv + BatchNorm layer (``_ApplyOps.conv``) is held tightly: output,
updated moving statistics and the gradients of (x, w, gamma, beta), plain,
with a sample mask, with an all-padding mask and with
``bn_stats_gradient=False``, in float32 — the same arithmetic over 1,024
samples per channel, summed in another order (rtol 1e-5).

The whole network is held to what float32 allows there.  Its moments are
E[y^2] - E[y]^2 in float32 (the JAX package's one-pass formula), whose
rounding depends on summation order, and at this test size (64 px, B=2)
the last BatchNorms see 8 samples per channel: the JAX package itself moves
its 2x2 raw grid by 2.6e-3 of its largest value under a 1e-7 relative
perturbation of the input (measured).  So the raw grids are held to 3e-2
of their largest value and 1e-2 in rel-RMS (measured here: up to 6.1e-3),
and the moving statistics, which take 1% of a batch statistic, to 1e-4
absolute.  The masked case pads two valid samples to three, so its
statistics see as many samples as the plain case.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import SHALLOW, images, torch_params, well_conditioned
from yolov4tpu.models import network as jnetwork
from yolov4tpu_torch.models import network as tnetwork

C = 3


def _layer(seed, cin=6, cout=8, k=3):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1 / np.sqrt(k * k * cin), (k, k, cin, cout))
    p = {"w": w.astype(np.float32),
         "gamma": rng.uniform(0.8, 1.2, cout).astype(np.float32),
         "beta": rng.normal(0, 0.1, cout).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.1, cout).astype(np.float32),
         "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)}
    x = rng.normal(0.5, 1.0, (4, 16, 16, cin)).astype(np.float32)
    cot = rng.normal(0, 1, (4, 16, 16, cout)).astype(np.float32)
    return p, s, x, cot


def _jax_layer(p, s, x, cot, mask, stats_gradient, downsampling):
    def f(x, p):
        ops = jnetwork._ApplyOps({"convs": [p]}, {"bn": [s]}, train=True,
                                 stats_gradient=stats_gradient,
                                 sample_mask=mask)
        y = ops.conv(x, p["w"].shape[-1], 3, downsampling=downsampling,
                     activation="mish")
        return jnp.sum(y * cot[:, :y.shape[1], :y.shape[2]]), (y, ops.new_bn)
    (_, (y, bn)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(x, p)
    return y, bn[0], grads


@pytest.mark.parametrize("mask,stats_gradient,downsampling,pallas", [
    (None, True, False, False),
    ([1, 1, 0, 1], True, False, False),
    (None, False, False, False),
    ([1, 0, 1, 0], False, True, False),
    (None, True, False, True),
])
def test_conv_bn_layer_matches_jax(mask, stats_gradient, downsampling,
                                   pallas):
    p, s, x, cot = _layer(0)
    m = None if mask is None else np.asarray(mask, np.float32)
    y_j, bn_j, (gx_j, gp_j) = _jax_layer(p, s, x, cot, m, stats_gradient,
                                         downsampling)

    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["w"] = tp["w"].permute(3, 2, 0, 1).contiguous()
    tp = {k: v.requires_grad_(True) for k, v in tp.items()}
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    ops = tnetwork._ApplyOps({"convs": [tp]}, {"bn": [ts]}, train=True,
                             stats_gradient=stats_gradient,
                             sample_mask=None if m is None
                             else torch.from_numpy(m),
                             pallas_wgrad=pallas)
    y = ops.conv(xt.permute(0, 3, 1, 2), 8, 3, downsampling=downsampling,
                 activation="mish").permute(0, 2, 3, 1)
    (y * torch.from_numpy(cot)[:, :y.shape[1], :y.shape[2]]).sum().backward()

    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    for k in ("mean", "var"):
        np.testing.assert_allclose(ops.new_bn[0][k].numpy(),
                                   np.asarray(bn_j[k]), rtol=1e-5, atol=1e-7)
        assert not ops.new_bn[0][k].requires_grad
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)
    for k in ("gamma", "beta"):
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp_j[k]),
                                   rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tp["w"].grad.permute(2, 3, 1, 0).numpy(),
                               np.asarray(gp_j["w"]), rtol=1e-4, atol=1e-4)


def test_all_padding_batch_stays_finite():
    """An all-padding micro-batch: unit variance instead of zero, finite
    outputs, as in the JAX package."""
    p, s, x, _ = _layer(1)
    m = np.zeros(4, np.float32)
    ops_j = jnetwork._ApplyOps({"convs": [p]}, {"bn": [s]}, train=True,
                               sample_mask=jnp.asarray(m))
    y_j = ops_j.conv(jnp.asarray(x), 8, 3)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    tp["w"] = tp["w"].permute(3, 2, 0, 1).contiguous()
    ts = {k: torch.from_numpy(v) for k, v in s.items()}
    ops = tnetwork._ApplyOps({"convs": [tp]}, {"bn": [ts]}, train=True,
                             sample_mask=torch.from_numpy(m))
    y = ops.conv(torch.from_numpy(x).permute(0, 3, 1, 2), 8, 3)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(y.permute(0, 2, 3, 1).numpy(), np.asarray(y_j),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ops.new_bn[0]["var"].numpy(),
                               np.asarray(ops_j.new_bn[0]["var"]), rtol=1e-6)


@pytest.mark.parametrize("mask,stats_gradient", [
    (None, True), ([1, 1, 0], False)])
def test_train_forward_matches_jax(mask, stats_gradient):
    params, state = well_conditioned(C)
    imgs = images(5, 2 if mask is None else len(mask)).astype(np.float32) / 255.0
    m = None if mask is None else np.asarray(mask, np.float32)
    fwd = jax.jit(lambda p, s, x, m: jnetwork.apply(
        p, s, x, C, train=True, csp_repeats=SHALLOW,
        bn_stats_gradient=stats_gradient, sample_mask=m))
    want, want_state = fwd(params, state, imgs, m)
    tp, ts = torch_params(C)
    with torch.no_grad():
        got, got_state = tnetwork.apply(
            tp, ts, torch.from_numpy(imgs), C, train=True,
            csp_repeats=SHALLOW, bn_stats_gradient=stats_gradient,
            sample_mask=None if m is None else torch.from_numpy(m))
    rows = slice(None) if m is None else m > 0
    for g, w in zip(got, want):
        g, w = g.numpy()[rows], np.asarray(w)[rows]
        assert g.shape == w.shape and g.dtype == np.float32
        scale = np.abs(w).max()
        assert np.abs(g - w).max() <= 3e-2 * scale
        assert np.sqrt(np.mean((g - w) ** 2)) <= 1e-2 * np.sqrt(np.mean(w ** 2))
    for g, w in zip(got_state["bn"], want_state["bn"]):
        assert (g is None) == (w is None)
        if g is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           rtol=0, atol=1e-4)


def test_inference_branch_uses_moving_stats():
    """apply(train=False) normalises by the state and returns it unchanged:
    equal to the BN-folded forward within float32 (the folding
    reassociates)."""
    tp, ts = torch_params(C)
    imgs = torch.from_numpy(images(6, 1).astype(np.float32) / 255.0)
    with torch.no_grad():
        got, st = tnetwork.apply(tp, ts, imgs, C, csp_repeats=SHALLOW)
        folded = tnetwork.apply_folded(tnetwork.fold_bn(tp, ts), imgs, C,
                                       csp_repeats=SHALLOW, s2d_stem=False)
    assert st is ts
    for g, w in zip(got, folded):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4)
