"""The conv epilogue kernel (csrc/conv_epilogue.cu) on the card: bit for
bit its plain version at every one of the 110 conv output shapes of the
416x416 batch-64 folded forward, in bfloat16 and float32; the scalar loop
(C = 255, a misaligned view) and an empty tensor; every bf16 value;
other memory layouts are copied into channels_last and launch too; one
folded forward makes 110 launches and gives the bits of the plain
forward; a forward captured into a CUDA graph in a new process, before
any epilogue ran there, replays the plain forward's bits, and so does a
graph captured after the mish table was filled.

Needs an NVIDIA card; without one every test skips.  On the card, where
JAX is not installed, without tests/conftest.py (which imports it):
``python -m pytest --noconftest -m cuda tests/test_torch_epilogue_cuda.py``.
This file imports nothing of JAX.
"""

import json
import pathlib
import subprocess
import sys

import pytest
import torch

from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import epilogue
from yolov4tpu_torch.tools.measure import epilogue_shapes

pytestmark = pytest.mark.cuda

ROOT = pathlib.Path(__file__).resolve().parent.parent

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA is not available)")
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def shapes():
    return epilogue_shapes(416, 64)


def conv_output(shape, dtype, card, seed):
    """A channels_last ``y`` of NCHW ``shape`` with values at the scales a
    conv gives and a tail past +-20, and its bias."""
    g = torch.Generator(device=card).manual_seed(seed)
    n, c, h, w = shape
    y = torch.randn((n, h, w, c), generator=g, device=card) * 6.0
    b = torch.randn((c,), generator=g, device=card)
    return (y.to(dtype).permute(0, 3, 1, 2), b.to(dtype))


def bits(t):
    t = t.contiguous(memory_format=torch.channels_last)
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_kernel_equals_plain_at_the_forwards_shapes(card, shapes, dtype):
    dt = DTYPES[dtype]
    launches = epilogue.LAUNCHES
    for i, (shape, act) in enumerate(shapes):
        y, b = conv_output(shape, dt, card, seed=i)
        got = epilogue.conv_epilogue(y, b, act)
        want = epilogue.conv_epilogue_reference(y, b, act)
        assert got.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(bits(got), bits(want)), (i, shape, act)
        del y, b, got, want
    torch.cuda.synchronize()
    assert epilogue.LAUNCHES == launches + len(shapes)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scalar_loop_and_empty(card, dtype):
    dt = DTYPES[dtype]
    for act in epilogue.ACTIVATIONS:
        y, b = conv_output((3, 255, 7, 5), dt, card, seed=1)
        assert torch.equal(bits(epilogue.conv_epilogue(y, b, act)),
                           bits(epilogue.conv_epilogue_reference(y, b, act)))
        # a view one value into its storage: not 16-byte aligned
        big, b = conv_output((1, 64, 9, 9), dt, card, seed=2)
        flat = big.permute(0, 2, 3, 1).reshape(-1)[1:1 + 80 * 64]
        y = flat.view(1, 8, 10, 64).permute(0, 3, 1, 2)
        assert y.is_contiguous(memory_format=torch.channels_last)
        assert torch.equal(bits(epilogue.conv_epilogue(y, b, act)),
                           bits(epilogue.conv_epilogue_reference(y, b, act)))
        empty = torch.empty((0, 64, 4, 4), dtype=dt, device=card).to(
            memory_format=torch.channels_last)
        assert epilogue.conv_epilogue(empty, b, act).shape == empty.shape
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_other_layouts_launch_the_kernel(card, dtype):
    """A CUDA tensor in another memory layout (NCHW-contiguous, a strided
    view) and a strided bias are copied into channels_last and launch the
    kernel: the plain version's values, in channels_last memory."""
    dt = DTYPES[dtype]
    y, b = conv_output((2, 64, 9, 7), dt, card, seed=3)
    wide = torch.stack([b, b], dim=1).reshape(-1)[::2]    # stride 2
    for act in epilogue.ACTIVATIONS:
        for x, bias in ((y.contiguous(), b), (y[:, :, ::2], wide)):
            launches = epilogue.LAUNCHES
            got = epilogue.conv_epilogue(x, bias, act)
            assert epilogue.LAUNCHES == launches + 1
            assert got.is_contiguous(memory_format=torch.channels_last)
            want = epilogue.conv_epilogue_reference(x, bias, act)
            assert torch.equal(bits(got), bits(want))


@pytest.mark.parametrize("act", ("mish", "leaky", "linear"))
def test_every_bf16_value(card, act):
    """All 65,536 bf16 bit patterns through the kernel with a bias of -0
    (which leaves every sum as it is): the same bits as the plain version,
    NaN where it gives NaN (the table route for mish)."""
    y = torch.arange(-32768, 32768, dtype=torch.int32, device=card)
    y = y.to(torch.int16).view(torch.bfloat16).view(1, 64, 128, 8)
    y = y.permute(0, 3, 1, 2)
    b = torch.full((8,), -0.0, dtype=torch.bfloat16, device=card)
    got = epilogue.conv_epilogue(y, b, act)
    want = epilogue.conv_epilogue_reference(y, b, act)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(bits(got)[~nan], bits(want)[~nan])


def folded_bf16(card, side=416):
    """Full-depth 80-class folded bf16 params with random biases (init's
    folded biases are all zero)."""
    params, state, _ = network.init(80, side, seed=0)
    folded = network.fold_bn(params, state)
    g = torch.Generator().manual_seed(0)
    for p in folded["convs"]:
        p["b"] = torch.randn(p["b"].shape, generator=g) * 0.5
    return network.prepare_folded(folded, card, torch.bfloat16)


def test_folded_forward_launches_once_a_conv(card, monkeypatch):
    folded = folded_bf16(card)
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.rand((2, 416, 416, 3), generator=g, device=card)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    with torch.inference_mode():
        launches = epilogue.LAUNCHES
        got = network.apply_folded(folded, x, 80, torch.bfloat16)
        assert epilogue.LAUNCHES == launches + 110
        monkeypatch.setattr(network, "conv_epilogue",
                            epilogue.conv_epilogue_reference)
        want = network.apply_folded(folded, x, 80, torch.bfloat16)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


# Run in a new process, so that no epilogue has run there yet: the
# forward's convs are warmed up with the plain epilogue, then the forward
# with the kernel is captured into a CUDA graph (its first epilogue
# launches happen inside the capture, which must not synchronise) and
# replayed; then an uncaptured forward fills the mish table and a second
# graph is captured.  Prints the comparisons as JSON.
GRAPH_SCRIPT = """
import json, sys
import torch
sys.path.insert(0, "tests")
from test_torch_epilogue_cuda import folded_bf16
from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import epilogue

torch.backends.cudnn.deterministic = True
card = torch.device("cuda")
folded = folded_bf16(card, 128)
g = torch.Generator(device=card).manual_seed(1)
x = torch.rand((2, 128, 128, 3), generator=g, device=card)
kernel = network.conv_epilogue


def forward():
    return network.apply_folded(folded, x, 80, torch.bfloat16)


out = {}
with torch.inference_mode():
    network.conv_epilogue = epilogue.conv_epilogue_reference
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        want = forward()
    torch.cuda.current_stream().wait_stream(side)
    network.conv_epilogue = kernel
    out["launches_before"] = epilogue.LAUNCHES
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = forward()
    out["captured_launches"] = epilogue.LAUNCHES
    out["table_after_capture"] = sorted(epilogue._TABLES)
    graph.replay()
    torch.cuda.synchronize()
    out["first_graph_equal"] = all(
        torch.equal(a, b) for a, b in zip(captured, want))
    eager = forward()
    out["eager_equal"] = all(torch.equal(a, b) for a, b in zip(eager, want))
    out["table_after_eager"] = sorted(epilogue._TABLES)
    graph.replay()
    second = torch.cuda.CUDAGraph()
    with torch.cuda.graph(second):
        again = forward()
    second.replay()
    torch.cuda.synchronize()
    out["replay_equal"] = all(
        torch.equal(a, b) for a, b in zip(captured, want))
    out["second_graph_equal"] = all(
        torch.equal(a, b) for a, b in zip(again, want))
print(json.dumps(out))
"""


def test_graph_capture_of_a_fresh_forward(card):
    proc = subprocess.run([sys.executable, "-c", GRAPH_SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["launches_before"] == 0
    assert out["captured_launches"] == 110
    assert out["table_after_capture"] == []     # no fill inside a capture
    assert out["table_after_eager"] == [0]
    assert out["first_graph_equal"] and out["eager_equal"]
    assert out["replay_equal"] and out["second_graph_equal"]
