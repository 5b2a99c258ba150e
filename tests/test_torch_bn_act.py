"""Training's BN + activation (``ops.bn_act``) on the CPU:

  - the plain version ``bn_act_reference`` (the eager chain every BN conv
    of the training forward runs off the card) against float64 autograd
    of the expression written out independently, and a float32 model of
    the CUDA kernels' closed-form backward (csrc/bn_act.cu: the sums of
    g act'(z) and g act'(z) y, then dgamma, dbeta and the statistics'
    terms) against the same: out, the new moving statistics, dy, dgamma
    and dbeta, over mish and leaky, ``stats_gradient`` on and off, and no
    mask, a partial mask and an all-padding mask;
  - the routing: ``network.apply(train=True)`` on the CPU launches
    nothing, and the training step's ``forward`` and ``backward`` spans
    count 0 ``bn_act`` and 0 ``bn_act_grad``;
  - ``_rows``: a channel slice of a channels_last tensor is read in place,
    other layouts are copied;
  - ``tools.measure.bn_act_shapes``: the 107 BN convs the card's checks
    use.

The kernels themselves are checked on the card
(tests/test_torch_bn_act_cuda.py, ``chip_smoke.py``).
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import bn_act
from yolov4tpu_torch.tools.measure import bn_act_shapes
from yolov4tpu_torch.train import Trainer
from yolov4tpu_torch.utils import profiling

SHAPE = (4, 16, 5, 6)      # N, C, H, W
MASKS = {"none": None, "partial": (1.0, 0.0, 1.0, 1.0),
         "padding": (0.0, 0.0, 0.0, 0.0)}


def inputs(seed):
    g = torch.Generator().manual_seed(seed)
    n, c, h, w = SHAPE

    def draw(*shape):
        return torch.randn(shape, generator=g, dtype=torch.float64)

    y = (draw(n, h, w, c) * 2.0 + 0.5).permute(0, 3, 1, 2)
    gamma = 1.0 + 0.2 * draw(c)
    beta = 0.3 * draw(c)
    mean = 0.2 * draw(c)
    var = 0.5 + draw(c).abs()
    grad = draw(n, c, h, w)
    return y, gamma, beta, mean, var, grad


def expression64(y, gamma, beta, mean, var, activation, mask,
                 stats_gradient):
    """The BN + activation written out in float64: the batch statistics
    over the valid samples (max(valid, 1) x H x W of them; an all-padding
    batch's E[y^2] + 1), the moving statistics at momentum 0.99, and the
    activation's textbook form."""
    n, _, h, w = y.shape
    wts = torch.ones(n, dtype=torch.float64) if mask is None \
        else torch.tensor(mask, dtype=torch.float64)
    valid = wts.sum()
    denom = torch.clamp(valid, min=1.0) * h * w
    ys = y * wts[:, None, None, None]
    m = ys.sum((0, 2, 3)) / denom
    m2 = (ys * ys).sum((0, 2, 3)) / denom + (0.0 if valid > 0 else 1.0)
    if not stats_gradient:
        m, m2 = m.detach(), m2.detach()
    v = torch.clamp(m2 - m * m, min=0.0)
    inv = 1.0 / torch.sqrt(v + 1e-3)
    z = y * (gamma * inv)[None, :, None, None] \
        + (beta - m * gamma * inv)[None, :, None, None]
    out = z * torch.tanh(F.softplus(z)) if activation == "mish" \
        else torch.where(z > 0, z, 0.1 * z)
    return (out, (0.99 * mean + 0.01 * m).detach(),
            (0.99 * var + 0.01 * v).detach())


def kernel_model(y, gamma, beta, mean, var, activation, mask,
                 stats_gradient, grad):
    """csrc/bn_act.cu's arithmetic in float32 on float32 ``y``: the
    statistics, scale and shift, out; then gz = g act'(z) (mish' from one
    exp), S = sum(gz), T = sum(gz y), dbeta = S, dgamma = inv (T - mean S),
    the statistics' terms and dy = gz scale + w (A + B y)."""
    n, c, h, w = y.shape
    wts = torch.ones(n) if mask is None else torch.tensor(mask)
    wb = wts[:, None, None, None]
    rows = (0, 2, 3)
    if mask is None:
        denom = torch.tensor(float(n * h * w))
        pad = 0.0
    else:
        valid = wts.sum()
        denom = torch.clamp(valid, min=1.0) * (h * w)
        pad = 0.0 if valid > 0 else 1.0
    ys = y * wb
    m = ys.sum(rows) / denom
    diff = (ys * ys).sum(rows) / denom + pad - m * m
    v = torch.clamp(diff, min=0.0)
    inv = torch.rsqrt(v + 1e-3)
    scale, shift = gamma * inv, beta - m * gamma * inv
    z = y * scale[:, None, None] + shift[:, None, None]
    if activation == "mish":
        u = torch.exp(torch.clamp(z, max=20.0))
        nn = u * (u + 2.0)
        out = torch.where(z > 20.0, z, z * (nn / (nn + 2.0)))
        wr = 1.0 / (nn + 2.0)
        d = torch.where(z > 20.0, 1.0,
                        nn * wr + z * (4.0 * u * (u + 1.0) * wr) * wr)
    else:
        out = torch.where(z > 0, z, z * 0.1)
        d = torch.where(z > 0, 1.0, 0.1)
    gz = grad * d
    s, t = gz.sum(rows), (gz * y).sum(rows)
    centred = t - m * s
    dgamma, dbeta = inv * centred, s
    a = b = torch.zeros(c)
    if stats_gradient:
        dvar = torch.where(diff >= 0, -0.5 * gamma * centred * inv ** 3, 0.0)
        dmean = -s * gamma * inv - 2.0 * m * dvar
        a, b = dmean / denom, 2.0 * dvar / denom
    dy = gz * scale[:, None, None] + wb * (a[:, None, None]
                                           + b[:, None, None] * y)
    return (out, 0.99 * mean + 0.01 * m, 0.99 * var + 0.01 * v, dy, dgamma,
            dbeta)


def autograd_of(fn, y, gamma, beta, grad):
    y, gamma, beta = (t.detach().requires_grad_(True)
                      for t in (y, gamma, beta))
    out, new_mean, new_var = fn(y, gamma, beta)
    dy, dgamma, dbeta = torch.autograd.grad(out, (y, gamma, beta), grad)
    return out.detach(), new_mean, new_var, dy, dgamma, dbeta


def rel_err(got, want):
    """max |got - want| over the largest |want| (1 where that is 0)."""
    scale = float(want.abs().max()) or 1.0
    return float((got.double() - want).abs().max()) / scale


@pytest.mark.parametrize("mask", sorted(MASKS))
@pytest.mark.parametrize("stats_gradient", [True, False])
@pytest.mark.parametrize("activation", ["mish", "leaky"])
def test_against_float64_autograd(activation, stats_gradient, mask):
    y, gamma, beta, mean, var, grad = inputs(7)
    want = autograd_of(
        lambda y_, g_, b_: expression64(y_, g_, b_, mean, var, activation,
                                        MASKS[mask], stats_gradient),
        y, gamma, beta, grad)
    f32 = [t.float() for t in (y, gamma, beta, mean, var, grad)]
    sample_mask = None if MASKS[mask] is None \
        else torch.tensor(MASKS[mask])
    got = autograd_of(
        lambda y_, g_, b_: bn_act.bn_act(y_, g_, b_, f32[3], f32[4],
                                         activation, sample_mask,
                                         stats_gradient),
        f32[0].contiguous(memory_format=torch.channels_last), *f32[1:3],
        f32[5])
    model = kernel_model(*f32[:5], activation, MASKS[mask], stats_gradient,
                         f32[5])
    names = ("out", "new_mean", "new_var", "dy", "dgamma", "dbeta")
    for name, g_ref, g_model, w in zip(names, got, model, want):
        # float32 against float64 (eps 1.2e-7): sums of 120 rows, one
        # rsqrt, mish; the largest seen is 4.6e-7.
        assert rel_err(g_ref, w) < 5e-6, f"reference {name}"
        assert rel_err(g_model, w) < 5e-6, f"kernel model {name}"
    if not stats_gradient or mask == "padding":
        # No statistics' term reaches y: dy = g act'(z) scale alone.
        _, _, _, dy_const, _, _ = autograd_of(
            lambda y_, g_, b_: expression64(y_, g_, b_, mean, var,
                                            activation, MASKS[mask], False),
            y, gamma, beta, grad)
        assert rel_err(got[3], dy_const) < 5e-6


def test_train_apply_on_the_cpu_launches_nothing():
    params, state, _ = network.init(3, 64, seed=0,
                                    csp_repeats=(1, 1, 1, 1, 1))
    images = torch.rand((2, 64, 64, 3))
    before = (bn_act.LAUNCHES, bn_act.GRAD_LAUNCHES)
    live = [p["gamma"].requires_grad_(True) for p in params["convs"]
            if "gamma" in p]
    outs, new_state = network.apply(params, state, images, 3, train=True,
                                    compute_dtype=torch.bfloat16,
                                    csp_repeats=(1, 1, 1, 1, 1))
    grads = torch.autograd.grad(sum(o.sum() for o in outs), live)
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    assert sum(s is not None for s in new_state["bn"]) == len(live)
    assert (bn_act.LAUNCHES, bn_act.GRAD_LAUNCHES) == before


def test_train_spans_count_no_launches_on_the_cpu(tiny_classes):
    """With SAT each step runs two forwards and two backwards."""
    params, state, _ = network.init(3, 64, seed=0,
                                    csp_repeats=(1, 1, 1, 1, 1))
    cfg = YoloConfig(img_size=(64, 64, 3), csp_repeats=(1, 1, 1, 1, 1),
                     batch_size=2)
    trainer = Trainer(dataclasses.replace(cfg, sat_epsilon=0.01), 3,
                      params, state, device="cpu")
    g = torch.Generator().manual_seed(0)
    raw = torch.zeros((2, cfg.max_boxes, 5))
    raw[:, 0] = torch.tensor([8.0, 8.0, 40.0, 40.0, 1.0])
    batch = {"image": torch.rand((2, 64, 64, 3), generator=g),
             "raw_boxes": raw}
    profiling.clear_spans()
    try:
        with profiling.recording():
            trainer.train_step(batch)
        got = [(s.name, s.counts) for s in profiling.spans()
               if s.name in ("forward", "backward")]
    finally:
        profiling.clear_spans()
    assert got == [("forward", {"bn_act": 0}),
                   ("backward", {"bn_act_grad": 0})] * 2


def test_rows_reads_channel_slices_in_place():
    base = torch.randn((2, 48, 3, 5)).contiguous(
        memory_format=torch.channels_last)
    part = base[:, 16:32]
    got, ld = bn_act._rows(part)
    assert got.data_ptr() == part.data_ptr() and ld == 48
    got, ld = bn_act._rows(base)
    assert got.data_ptr() == base.data_ptr() and ld == 48
    nchw = torch.randn((2, 8, 3, 5))
    got, ld = bn_act._rows(nchw)
    assert ld == 8 and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, nchw)


def test_bn_act_shapes_are_the_107_bn_convs():
    shapes = bn_act_shapes(608, 8)
    assert len(shapes) == 107
    assert sum(a == "mish" for _, a in shapes) == 70
    assert shapes[0] == ((8, 32, 608, 608), "leaky")
    values = sum(n * c * h * w for (n, c, h, w), _ in shapes)
    assert values == 8 * 112_470_272
