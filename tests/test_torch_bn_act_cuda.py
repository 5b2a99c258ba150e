"""Training's BN + activation kernels (csrc/bn_act.cu) on the card:

  - the forward's output equals the eager ``_activate(y * scale + shift)``
    bit for bit, given the kernel's own scale and shift, at every one of
    the 107 BN convs of a 608x608 batch-8 training forward, in bfloat16
    and float32; the scale and shift are the eager expression's of the
    kernel's mean and inv, bit for bit; the scalar route (C not a multiple
    of the vector) too;
  - the batch statistics within 1e-5 of float64 (relative to E[y^2]);
  - dy, dgamma and dbeta at those 107 shapes, over three seeds, at least
    as close to float32 autograd of the bf16 forward (``bn_act_float32``:
    its roundings in value, gradients straight through them) as the eager
    bf16 autograd is; two runs give the same bits;
  - masks (partial, all padding) and ``stats_gradient=False``: float32
    kernels against float32 autograd of the plain version;
  - a gradient that is a channel slice of a wider tensor is read in place,
    with the bits of its contiguous copy;
  - one ``train_step`` of the full-depth model on the card: its spans
    count 107 ``bn_act`` and 107 ``bn_act_grad``, 214 each with SAT.

Needs an NVIDIA card; without one every test skips.  On the card, where
JAX is not installed, without tests/conftest.py (which imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_bn_act_cuda.py``.
This file imports nothing of JAX.
"""

import pytest
import torch

from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import bn_act
from yolov4tpu_torch.ops.epilogue import _activate
from yolov4tpu_torch.tools.measure import bn_act_float32, bn_act_shapes
from yolov4tpu_torch.train import Trainer
from yolov4tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shapes():
    return bn_act_shapes(608, 8)


def site(shape, dtype, card, seed):
    """A conv output ``y`` (channels_last, per-channel offsets and
    spreads), its BN's gamma, beta, moving mean and var, and a gradient
    of the output."""
    g = torch.Generator(device=card).manual_seed(seed)
    n, c, h, w = shape

    def draw(*s):
        return torch.randn(s, generator=g, device=card)

    spread = 0.5 + 2.5 * torch.rand((c,), generator=g, device=card)
    y = draw(n, h, w, c) * spread + draw(c)
    grad = draw(n, h, w, c)
    return (y.to(dtype).permute(0, 3, 1, 2), 1.0 + 0.2 * draw(c),
            0.3 * draw(c), 0.2 * draw(c), 0.5 + draw(c).abs(),
            grad.to(dtype).permute(0, 3, 1, 2))


def bits(t):
    t = t.contiguous(memory_format=torch.channels_last)
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def eager_given(y, stats, activation):
    """The eager expression with the kernel's scale and shift."""
    scale, shift = (stats[r].to(y.dtype).view(1, -1, 1, 1) for r in (3, 4))
    return _activate(y * scale + shift, activation)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_forward_is_the_eager_expression_bit_for_bit(card, shapes, dtype):
    dt = DTYPES[dtype]
    launches = bn_act.LAUNCHES
    for i, (shape, act) in enumerate(shapes):
        y, gamma, beta, mean, var, _ = site(shape, dt, card, seed=i)
        out, stats, _, _ = bn_act.bn_act_forward(y, gamma, beta, mean, var,
                                                 act)
        assert out.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(bits(out), bits(eager_given(y, stats, act))), \
            (i, shape, act)
        m, inv = stats[0], stats[2]
        assert torch.equal(stats[3], (gamma * inv).to(dt).float())
        assert torch.equal(stats[4], (beta - m * gamma * inv).to(dt).float())
        del y, out
    torch.cuda.synchronize()
    assert bn_act.LAUNCHES == launches + len(shapes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scalar_route(card, dtype):
    dt = DTYPES[dtype]
    for act in sorted(bn_act.ACTIVATIONS):
        y, gamma, beta, mean, var, grad = site((3, 20, 7, 5), dt, card, 1)
        out, stats, _, _ = bn_act.bn_act_forward(y, gamma, beta, mean, var,
                                                 act)
        assert torch.equal(bits(out), bits(eager_given(y, stats, act)))


def test_statistics_against_float64(card, shapes):
    for i, (shape, act) in enumerate(shapes):
        y, gamma, beta, mean, var, _ = site(shape, torch.bfloat16, card, i)
        _, stats, new_mean, new_var = bn_act.bn_act_forward(
            y, gamma, beta, mean, var, act)
        y64 = y.double()
        m64 = y64.mean((0, 2, 3))
        m2 = y64.square().mean((0, 2, 3))
        v64 = m2 - m64.square()
        mean32, var32 = stats[0].double(), stats[1].double().clamp(min=0)
        assert float(((mean32 - m64).abs() / m2.sqrt()).max()) < 1e-5, i
        assert float(((var32 - v64).abs() / m2).max()) < 1e-5, i
        want_mean = 0.99 * mean.double() + 0.01 * m64
        want_var = 0.99 * var.double() + 0.01 * v64
        assert float(((new_mean - want_mean).abs()
                      / (want_mean.abs() + m2.sqrt() / 100)).max()) < 1e-5
        assert float(((new_var - want_var).abs() / want_var).max()) < 1e-5


def grads_of(fn, y, gamma, beta, grad):
    y, gamma, beta = (t.detach().requires_grad_(True)
                      for t in (y, gamma, beta))
    out, _, _ = fn(y, gamma, beta)
    return torch.autograd.grad(out, (y, gamma, beta), grad)


def rel_rms(got, want):
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp(
        min=1e-30))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_backward_is_closer_to_float32_than_eager_bf16(card, shapes, seed):
    for i, (shape, act) in enumerate(shapes):
        y, gamma, beta, mean, var, grad = site(
            shape, torch.bfloat16, card, 1000 * seed + i)

        def plain(y_, g_, b_):
            return bn_act.bn_act_reference(y_, g_, b_, mean, var, act)

        def kernels(y_, g_, b_):
            return bn_act.bn_act(y_, g_, b_, mean, var, act)

        def yardstick(y_, g_, b_):
            return bn_act_float32(y_, g_, b_, mean, var, act)

        want = grads_of(yardstick, y, gamma, beta, grad.float())
        eager = grads_of(plain, y, gamma, beta, grad)
        got = grads_of(kernels, y, gamma, beta, grad)
        again = grads_of(kernels, y, gamma, beta, grad)
        for name, g, e, w, a in zip(("dy", "dgamma", "dbeta"), got, eager,
                                    want, again):
            assert torch.equal(g, a), (i, name)
            assert rel_rms(g, w) <= rel_rms(e, w), \
                (i, shape, act, name, rel_rms(g, w), rel_rms(e, w))
        del y, grad, want, eager, got, again


MASKS = {"partial": (1.0, 0.0, 1.0, 1.0), "padding": (0.0,) * 4}


@pytest.mark.parametrize("mask", [None, *sorted(MASKS)])
@pytest.mark.parametrize("stats_gradient", [True, False])
@pytest.mark.parametrize("act", ["mish", "leaky"])
def test_masks_and_constant_statistics(card, mask, stats_gradient, act):
    y, gamma, beta, mean, var, grad = site((4, 64, 19, 19), torch.float32,
                                           card, 5)
    sample_mask = None if mask is None \
        else torch.tensor(MASKS[mask], device=card)

    def run(fn):
        y_, g_, b_ = (t.detach().requires_grad_(True)
                      for t in (y, gamma, beta))
        out, new_mean, new_var = fn(y_, g_, b_, mean, var, act, sample_mask,
                                    stats_gradient)
        grads = torch.autograd.grad(out, (y_, g_, b_), grad)
        return (out, new_mean, new_var, *grads)

    got, want = run(bn_act.bn_act), run(bn_act.bn_act_reference)
    for name, g, w in zip(("out", "new_mean", "new_var", "dy", "dgamma",
                           "dbeta"), got, want):
        assert rel_rms(g, w) < 1e-5, (name, rel_rms(g, w))


def test_a_channel_slice_of_the_gradient_is_read_in_place(card):
    y, gamma, beta, mean, var, _ = site((2, 64, 13, 11), torch.bfloat16,
                                        card, 3)
    _, _, _, _, _, wide = site((2, 192, 13, 11), torch.bfloat16, card, 4)
    part = wide[:, 64:128]
    _, stats, _, _ = bn_act.bn_act_forward(y, gamma, beta, mean, var, "mish")
    got = bn_act.bn_act_backward(part, y, gamma, stats, "mish")
    want = bn_act.bn_act_backward(part.contiguous(
        memory_format=torch.channels_last), y, gamma, stats, "mish")
    assert torch.equal(bits(got[0]), bits(want[0]))
    assert torch.equal(got[1], want[1])


@pytest.mark.parametrize("sat", [0.0, 0.01])
def test_train_step_spans_count_the_kernels(card, sat):
    params, state, _ = network.init(80, 128, seed=0)
    cfg = YoloConfig(img_size=(128, 128, 3), batch_size=2,
                     compute_dtype="bfloat16", sat_epsilon=sat)
    trainer = Trainer(cfg, 80, params, state, device="cuda")
    raw = torch.zeros((2, cfg.max_boxes, 5))
    raw[:, 0] = torch.tensor([8.0, 8.0, 90.0, 70.0, 3.0])
    g = torch.Generator().manual_seed(0)
    batch = {"image": torch.rand((2, 128, 128, 3), generator=g).cuda(),
             "raw_boxes": raw.cuda()}
    trainer.train_step(batch)
    profiling.clear_spans()
    try:
        with profiling.recording():
            loss = float(trainer.train_step(batch)["loss"])
        torch.cuda.synchronize()
        spans = profiling.spans()
    finally:
        profiling.clear_spans()
    fwd = sum(s.counts["bn_act"] for s in spans if s.name == "forward")
    bwd = sum(s.counts["bn_act_grad"] for s in spans
              if s.name == "backward")
    per_pass = 2 if sat else 1
    assert (fwd, bwd) == (107 * per_pass, 107 * per_pass)
    assert loss == loss and abs(loss) < float("inf")

