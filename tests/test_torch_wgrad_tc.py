"""The tensor-core (bfloat16) route of the port's 3x3 stride-1 weight
gradient (yolov4tpu_torch.ops.wgrad_cuda), on the CPU: its split-K plan,
the constants the plan shares with the kernel source, the build's digest
of that source, the shapes the card's scripts time, and the channel
padding.  The kernel itself runs only on the card, where chip_smoke.py
holds it against the plain version.

The padded inputs go through the plain version, and the sliced result is
held to the plain version of the unpadded inputs, the JAX package's Pallas
kernel in interpret mode and XLA autodiff's wgrad, on the same numpy
inputs.  Tolerances as in tests/test_torch_wgrad.py (rtol 1e-5, atol 1e-4:
float32 sums of up to B*H*W products in another order).  For bfloat16 both
sides multiply the same bf16-rounded values exactly and sum in float32;
XLA's wgrad is taken in float32 on those values, since its bfloat16
result is rounded to bfloat16.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4tpu.ops.wgrad_pallas import wgrad_3x3_s1 as jwgrad
from yolov4tpu.ops.wgrad_pallas import wgrad_xla_3x3_s1
from yolov4tpu_torch.ops import build as kbuild
from yolov4tpu_torch.ops import wgrad_cuda
from yolov4tpu_torch.tools import measure

REPO = pathlib.Path(__file__).resolve().parents[1]
SMS = 132  # the H100's streaming multiprocessors


# (tile, splits, chunk) on the H100's 132 SMs.  float32: the plan of the
# CUDA-core route before the tensor-core route came, which it keeps.
# bfloat16: the plan the tensor-core route's times in PERF.md were taken
# with (the invariants of both are test_torch_wgrad.py's
# test_plan_covers_every_pixel).
@pytest.mark.parametrize("shape, f32, bf16", [
    ((8, 416, 416, 3, 32), (64, 528, 2624), (64, 264, 5248)),
    ((8, 52, 52, 128, 128), (128, 41, 528), (128, 29, 768)),
    ((8, 13, 13, 512, 1024), (128, 2, 688), (128, 1, 1376)),
    ((32, 416, 416, 3, 32), (64, 528, 10496), (64, 676, 8192)),
    ((3, 13, 17, 5, 7), (64, 1, 672), (64, 2, 352)),
    ((1, 1, 1, 1, 1), (64, 1, 16), (64, 1, 32))])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plan_pinned(shape, f32, bf16, dtype):
    want = f32 if dtype == torch.float32 else bf16
    assert wgrad_cuda.plan(*shape, SMS, dtype) == want


def test_plan_constants_match_the_kernel_source():
    """plan()'s K step and resident blocks are the kernel's (the library
    checks them again when it loads on the card)."""
    src = (REPO / "yolov4tpu_torch/csrc/wgrad_3x3.cu").read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))

    assert const("kTcStep") == wgrad_cuda._TC_STEP
    assert wgrad_cuda._TC_BLOCKS_PER_SM == {128: const("kTcBlocks128"),
                                            64: const("kTcBlocks64")}


def test_build_digest_follows_included_sources(tmp_path):
    """A kernel library is rebuilt when a source it includes changes."""
    (tmp_path / "a.cu").write_text('#include "b.cu"\n#include <stdint.h>\n')
    (tmp_path / "b.cu").write_text("int b;\n")
    first = kbuild.digest(tmp_path / "a.cu")
    assert kbuild.digest(tmp_path / "a.cu") == first
    (tmp_path / "b.cu").write_text("int b2;\n")
    assert kbuild.digest(tmp_path / "a.cu") != first
    probe = kbuild.CSRC / "wgrad_probe.cu"
    assert '#include "wgrad_3x3.cu"' in probe.read_text()


def test_wgrad_shapes_of_the_training_path():
    """The 37 3x3 stride-1 convs of YOLOv4 at 416^2 in nine shapes, which
    chip_smoke.py and tools/wgrad_probe.py time."""
    assert dict(measure.wgrad_shapes()) == {
        (416, 3, 32): 1, (208, 32, 64): 1, (104, 64, 64): 2,
        (52, 128, 128): 8, (52, 128, 256): 3, (26, 256, 256): 8,
        (26, 256, 512): 5, (13, 512, 512): 4, (13, 512, 1024): 5}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 8, 3, 20), (3, 13, 17, 5, 7)])
def test_padded_channels_slice_back(shape, dtype):
    b, h, w, ci, co = shape
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (b, h, w, ci)).astype(np.float32)
    dy = rng.normal(0, 1, (b, h, w, co)).astype(np.float32)
    xt, dyt = torch.from_numpy(x).to(dtype), torch.from_numpy(dy).to(dtype)
    xp, dyp = wgrad_cuda.pad_channels(xt), wgrad_cuda.pad_channels(dyt)
    assert xp.shape[-1] % 8 == 0 and dyp.shape[-1] % 8 == 0
    assert xp.shape[-1] - ci < 8 and dyp.shape[-1] - co < 8
    assert not xp[..., ci:].any() and not dyp[..., co:].any()
    assert torch.equal(xp[..., :ci], xt) and torch.equal(dyp[..., :co], dyt)

    got = wgrad_cuda.wgrad_3x3_s1_reference(xp, dyp)[:, :, :ci, :co]
    assert got.shape == (3, 3, ci, co) and got.dtype == torch.float32
    want = wgrad_cuda.wgrad_3x3_s1_reference(xt, dyt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    # The same (possibly bf16-rounded) values on the JAX side.
    xj = jnp.asarray(x, jnp.bfloat16 if dtype == torch.bfloat16 else None)
    dyj = jnp.asarray(dy, jnp.bfloat16 if dtype == torch.bfloat16 else None)
    np.testing.assert_array_equal(np.asarray(xj, np.float32),
                                  xt.float().numpy())
    pallas = np.asarray(jwgrad(xj, dyj, bt=b, ht=h, interpret=True))
    xla = np.asarray(wgrad_xla_3x3_s1(xj.astype(jnp.float32),
                                      dyj.astype(jnp.float32)))
    np.testing.assert_allclose(got.numpy(), pallas, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.numpy(), xla, rtol=1e-5, atol=1e-4)


def test_pad_channels_keeps_aligned_tensors_and_copies_the_rest():
    t = torch.zeros(2, 5, 5, 16, dtype=torch.bfloat16)
    assert wgrad_cuda.pad_channels(t) is t
    # A contiguous view one element into its storage: 2 bytes off 16.
    flat = torch.arange(2 * 5 * 5 * 16 + 1, dtype=torch.float32).bfloat16()
    view = flat[1:].view(2, 5, 5, 16)
    assert view.data_ptr() % 16 != 0
    fixed = wgrad_cuda.pad_channels(view)
    assert fixed.data_ptr() % 16 == 0 and torch.equal(fixed, view)
    # Not NHWC-contiguous: made so.
    nchw = torch.randn(2, 16, 5, 5).bfloat16().permute(0, 2, 3, 1)
    assert wgrad_cuda.pad_channels(nchw).is_contiguous()


def test_cpu_tensors_run_the_plain_version_without_launching():
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(0, 1, (2, 7, 9, 5))).bfloat16()
    dy = torch.from_numpy(rng.normal(0, 1, (2, 7, 9, 3))).bfloat16()
    launches, tc = wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES
    got = wgrad_cuda.wgrad_3x3_s1(x, dy)
    assert (wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES) == (launches, tc)
    assert torch.equal(got, wgrad_cuda.wgrad_3x3_s1_reference(x, dy))
