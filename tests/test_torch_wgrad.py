"""The port's 3x3 stride-1 weight gradient (yolov4tpu_torch.ops.wgrad_cuda)
against the JAX package's (ops.wgrad_pallas): the plain version against the
Pallas kernel in interpret mode and against XLA autodiff's wgrad, on the same
numpy inputs; and the port's ``conv3x3_s1`` against autograd of
``F.conv2d``.  The CUDA kernel itself is held against the plain version on
the card by chip_smoke.py.

Tolerances: float32 as tests/test_wgrad_pallas.py holds the Pallas kernel
(rtol 1e-5, atol 1e-4: float32 sums of up to B*H*W products in another
order).  bfloat16 operands: both sides multiply the same bf16-rounded values
exactly and sum in float32, so the float32 tolerance holds there too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from yolov4tpu.ops.wgrad_pallas import wgrad_3x3_s1 as jwgrad
from yolov4tpu.ops.wgrad_pallas import wgrad_xla_3x3_s1
from yolov4tpu_torch.ops import wgrad_cuda


def _pair(shape, seed, dtype=np.float32):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, w, ci)).astype(np.float32)
    dy = rng.normal(0, 1, (b, h, w, co)).astype(np.float32)
    return x, dy


@pytest.mark.parametrize("shape", [
    (4, 16, 16, 8, 16),    # B,H,W,Ci,Co — the shapes of test_wgrad_pallas
    (2, 13, 13, 16, 8),    # odd H/W (13^2 head grid)
    (4, 26, 24, 8, 8),
])
def test_reference_matches_pallas_and_xla_f32(shape):
    x, dy = _pair(shape, 0)
    ht = 13 if shape[1] == 13 else 8 if shape[1] % 8 == 0 else shape[1]
    pallas = np.asarray(jwgrad(jnp.asarray(x), jnp.asarray(dy), bt=2, ht=ht,
                               interpret=True))
    xla = np.asarray(wgrad_xla_3x3_s1(jnp.asarray(x), jnp.asarray(dy)))
    got = wgrad_cuda.wgrad_3x3_s1(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.shape == (3, 3, shape[3], shape[4])
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-4)


def test_reference_bf16_operands_accumulate_f32():
    x, dy = _pair((4, 16, 16, 8, 8), 1)
    xb, dyb = jnp.asarray(x, jnp.bfloat16), jnp.asarray(dy, jnp.bfloat16)
    pallas = np.asarray(jwgrad(xb, dyb, bt=2, ht=8, interpret=True))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    dyt = torch.from_numpy(dy).to(torch.bfloat16)
    got = wgrad_cuda.wgrad_3x3_s1(xt, dyt)
    assert got.dtype == torch.float32
    # The same bf16 roundings on both sides (round-to-nearest-even).
    np.testing.assert_array_equal(xt.float().numpy(),
                                  np.asarray(xb, np.float32))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("corner", [(0, 0), (7, 7), (0, 7)])
def test_edge_taps_see_zero_padding_exactly(corner):
    """A delta at a corner pixel pairs with itself through the centre tap
    only; every tap that reaches outside the image sees zeros."""
    b, h, w, ci, co = 1, 8, 8, 8, 8
    y, x0 = corner
    x = np.zeros((b, h, w, ci), np.float32)
    x[0, y, x0, 0] = 1.0
    dy = np.zeros((b, h, w, co), np.float32)
    dy[0, y, x0, 0] = 1.0
    got = wgrad_cuda.wgrad_3x3_s1(torch.from_numpy(x), torch.from_numpy(dy))
    want = np.zeros((3, 3, ci, co), np.float32)
    want[1, 1, 0, 0] = 1.0
    np.testing.assert_array_equal(got.numpy(), want)
    pallas = np.asarray(jwgrad(jnp.asarray(x), jnp.asarray(dy), bt=1, ht=8,
                               interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)


def test_ragged_shape_matches_xla():
    x, dy = _pair((3, 13, 17, 5, 7), 2)
    xla = np.asarray(wgrad_xla_3x3_s1(jnp.asarray(x), jnp.asarray(dy)))
    got = wgrad_cuda.wgrad_3x3_s1(torch.from_numpy(x), torch.from_numpy(dy))
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_conv3x3_s1_matches_conv2d_autograd(dtype, tol):
    """Forward, dx and dw against autograd of F.conv2d on NCHW tensors in
    channels_last memory (the port's layout).  dw is cast to the weight's
    dtype as the JAX backward casts it, so bf16 holds to bf16 rounding of
    the largest value."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(0, 1, (2, 6, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (5, 6, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (2, 5, 9, 9)).astype(np.float32))
    x = x.to(dtype).contiguous(memory_format=torch.channels_last)
    w = w.to(dtype)

    def run(fn):
        xv = x.detach().requires_grad_(True)
        wv = w.detach().requires_grad_(True)
        y = fn(xv, wv)
        y.backward(g.to(dtype))
        return y.detach().float(), xv.grad.float(), wv.grad
    y0, dx0, dw0 = run(lambda a, b: F.conv2d(a, b, padding=1))
    y1, dx1, dw1 = run(wgrad_cuda.conv3x3_s1)
    assert dw1.dtype == dtype and dx1.shape == x.shape
    for a, b in [(y1, y0), (dx1, dx0), (dw1.float(), dw0.float())]:
        scale = float(b.abs().max())
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=tol * scale)


def test_conv3x3_s1_dw_from_any_dy_layout():
    """A cotangent that is not channels_last gives the same dw (the
    wrapper makes it NHWC-contiguous)."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(0, 1, (2, 4, 7, 7)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 0.3, (3, 4, 3, 3)).astype(np.float32))
    g = torch.from_numpy(rng.normal(0, 1, (2, 3, 7, 7)).astype(np.float32))
    grads = []
    for gg in (g.contiguous(), g.contiguous(memory_format=torch.channels_last)):
        wv = w.detach().requires_grad_(True)
        wgrad_cuda.conv3x3_s1(x, wv).backward(gg)
        grads.append(wv.grad)
    np.testing.assert_array_equal(grads[0].numpy(), grads[1].numpy())


@pytest.mark.parametrize("shape", [
    (8, 416, 416, 3, 32), (8, 13, 13, 512, 1024), (8, 52, 52, 128, 128),
    (32, 416, 416, 3, 32), (3, 13, 17, 5, 7), (1, 1, 1, 1, 1),
    (8, 208, 208, 32, 64), (8, 104, 104, 64, 64), (8, 52, 52, 128, 256),
    (8, 26, 26, 256, 256), (8, 26, 26, 256, 512), (8, 13, 13, 512, 512),
    (32, 13, 13, 512, 1024), (2, 13, 17, 3, 20)])
def test_plan_covers_every_pixel(shape):
    """The split-K plan of each route: every pixel in exactly one split,
    splits within the grid's z limit, chunks on K-step boundaries (16
    pixels on the float32 route, 32 on the bfloat16 tensor-core route),
    and the tile the kernel has for these channel counts (padded to
    multiples of 8 on the tensor-core route).  On the tensor-core route a
    split also takes at least 8 K steps when K is split and at most 256
    (the mma's float32 chains stay short), and the grid goes past one wave
    of resident blocks (2 a SM for the 128 tile, 4 for the 64) only where
    the output tiles or the cap on the chains need it."""
    b, h, w, ci, co = shape
    k = b * h * w
    for dtype, step, (cip, cop) in (
            (torch.float32, 16, (ci, co)),
            (torch.bfloat16, 32, (-(-ci // 8) * 8, -(-co // 8) * 8))):
        tile, splits, chunk = wgrad_cuda.plan(b, h, w, ci, co, 132, dtype)
        assert tile in (64, 128) and chunk % step == 0
        assert 1 <= splits <= 65535
        assert (splits - 1) * chunk < k <= splits * chunk
        assert tile == (128 if cip >= 128 and cop >= 128 else 64)
    assert splits == 1 or chunk >= 8 * 32
    assert chunk <= 256 * 32
    tiles = -(-(9 * cip) // tile) * -(-cop // tile)
    slots = {128: 2, 64: 4}[tile] * 132
    fewest = -(-(-(-k // 32)) // 256)
    assert tiles * splits <= max(tiles, slots) or splits == fewest


def test_wrapper_rejects_mismatched_inputs():
    x = torch.zeros(1, 4, 4, 2)
    with pytest.raises(ValueError):
        wgrad_cuda.wgrad_3x3_s1(x, torch.zeros(1, 4, 5, 2))
    with pytest.raises(TypeError):
        wgrad_cuda.wgrad_3x3_s1(x, torch.zeros(1, 4, 4, 2,
                                               dtype=torch.bfloat16))
