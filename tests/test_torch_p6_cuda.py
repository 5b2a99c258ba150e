"""The conv epilogue's second mode (``conv_epilogue_merge``,
csrc/conv_epilogue.cu's ``epilogue_merge`` kernels) and YOLOv4-P6's
folded forward on the card: the kernel equals its plain version bit for
bit at the 7 second-stage shapes of a 1280x1280 batch-16 forward, in
bfloat16 and float32, on every bf16 value, and on the scalar route (C =
340, a misaligned view); one P6 folded forward makes 205 epilogue
launches, 7 of them merges, with the plain forward's bits; the
``forward`` span of ``predict_batch`` counts 205 / 205 / 7 for P6 and
110 / 110 / 0 for YOLOv4.

Needs an NVIDIA card; without one every test skips.  On the card, where
JAX is not installed, without tests/conftest.py (which imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_p6_cuda.py``.
This file imports nothing of JAX.
"""

import numpy as np
import pytest
import torch

from perfbench.reference import scaled_yolov4 as ref
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import YoloConfig, p6_config
from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import epilogue
from yolov4tpu_torch.utils import profiling

pytestmark = pytest.mark.cuda

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
ONE = (1,) * 7


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def operands(shape, dtype, card, seed):
    """A channels_last ``y`` of NCHW ``shape`` at a conv's scales with a
    tail past +-20, and (b, s, t) as a folded BN gives them."""
    g = torch.Generator(device=card).manual_seed(seed)
    n, c, h, w = shape
    y = torch.randn((n, h, w, c), generator=g, device=card) * 6.0
    b, t = (torch.randn((c,), generator=g, device=card) for _ in range(2))
    s = 0.3 + torch.rand((c,), generator=g, device=card) * 2.0
    return (y.to(dtype).permute(0, 3, 1, 2),
            *(v.to(dtype) for v in (b, s, t)))


def bits(t):
    t = t.contiguous(memory_format=torch.channels_last)
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merge_equals_plain_at_the_seven_sites(card, dtype):
    sites = ref.second_stage_sites(1280)
    assert len(sites) == 7
    launches, merges = epilogue.LAUNCHES, epilogue.MERGES
    for i, (c, h, w) in enumerate(sites):
        y, b, s, t = operands((16, c, h, w), DTYPES[dtype], card, seed=i)
        got = epilogue.conv_epilogue_merge(y, b, s, t)
        want = epilogue.conv_epilogue_merge_reference(y, b, s, t)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(bits(got), bits(want)), (i, c, h, w)
        del y, got, want
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES == launches + 7
    assert epilogue.MERGES == merges + 7


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merge_scalar_route(card, dtype):
    dt = DTYPES[dtype]
    y, b, s, t = operands((3, 340, 7, 5), dt, card, seed=1)
    assert torch.equal(bits(epilogue.conv_epilogue_merge(y, b, s, t)),
                       bits(epilogue.conv_epilogue_merge_reference(y, b, s,
                                                                   t)))
    big, b, s, t = operands((1, 64, 9, 9), dt, card, seed=2)
    flat = big.permute(0, 2, 3, 1).reshape(-1)[1:1 + 80 * 64]
    y = flat.view(1, 8, 10, 64).permute(0, 3, 1, 2)    # not 16-byte aligned
    assert torch.equal(bits(epilogue.conv_epilogue_merge(y, b, s, t)),
                       bits(epilogue.conv_epilogue_merge_reference(y, b, s,
                                                                   t)))


def test_merge_every_bf16_value(card):
    """All 65,536 bf16 bit patterns as y, with b = -0 (sums unchanged) and
    (s, t) at four pairs: the plain version's bits, NaN where it gives
    NaN."""
    y = torch.arange(-32768, 32768, dtype=torch.int32, device=card)
    y = y.to(torch.int16).view(torch.bfloat16).view(1, 64, 128, 8)
    y = y.permute(0, 3, 1, 2)
    b = torch.full((8,), -0.0, dtype=torch.bfloat16, device=card)
    for sv, tv in ((1.0, 0.0), (0.37, -1.5), (2.5, 0.75), (0.9, 3.0)):
        s = torch.full((8,), sv, dtype=torch.bfloat16, device=card)
        t = torch.full((8,), tv, dtype=torch.bfloat16, device=card)
        got = epilogue.conv_epilogue_merge(y, b, s, t)
        want = epilogue.conv_epilogue_merge_reference(y, b, s, t)
        nan = torch.isnan(want)
        assert torch.equal(torch.isnan(got), nan)
        assert torch.equal(bits(got)[~nan], bits(want)[~nan])


def test_p6_folded_forward_launches_once_a_conv(card, monkeypatch):
    params, state = ref.make(0, 80, card, ONE)
    folded = network.prepare_folded(
        network.fold_bn(params, state, network.conv_specs(80, ONE,
                                                          "yolov4-p6")),
        card, torch.bfloat16)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.rand((2, 256, 256, 3), generator=g, device=card)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    with torch.inference_mode():
        launches, merges = epilogue.LAUNCHES, epilogue.MERGES
        got = network.apply_folded(folded, x, 80, torch.bfloat16,
                                   csp_repeats=ONE, arch="yolov4-p6")
        assert epilogue.LAUNCHES == launches + len(folded["convs"])
        assert epilogue.MERGES == merges + 7
        monkeypatch.setattr(network, "conv_epilogue",
                            epilogue.conv_epilogue_reference)
        monkeypatch.setattr(network, "conv_epilogue_merge",
                            epilogue.conv_epilogue_merge_reference)
        want = network.apply_folded(folded, x, 80, torch.bfloat16,
                                    csp_repeats=ONE, arch="yolov4-p6")
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def forward_counts(model, side):
    profiling.clear_spans()
    try:
        with profiling.recording():
            [o.cpu() for o in model.predict_batch(
                np.zeros((1, side, side, 3), np.uint8))]
        (fwd,) = [s for s in profiling.spans() if s.name == "forward"]
    finally:
        profiling.clear_spans()
    return fwd.counts


def test_forward_span_counts_on_the_card(card, tmp_path):
    classes = tmp_path / "classes.txt"
    classes.write_text("".join(f"c{i}\n" for i in range(80)))
    p6 = Yolov4(None, str(classes), device=card,
                config=p6_config(img_size=(256, 256, 3),
                                 compute_dtype="bfloat16"))
    v4 = Yolov4(None, str(classes), device=card,
                config=YoloConfig(img_size=(256, 256, 3),
                                  compute_dtype="bfloat16"))
    assert forward_counts(p6, 256) == {"convs": 205,
                                       "epilogue_launches": 205,
                                       "merges": 7}
    assert forward_counts(v4, 256) == {"convs": 110,
                                       "epilogue_launches": 110,
                                       "merges": 0}
