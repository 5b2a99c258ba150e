"""The conv epilogue (``ops.epilogue``) on the CPU:

  - a plain model of the CUDA kernel's steps (float32 operations, each
    rounded to bfloat16 where the eager chain stores a bf16 tensor, in the
    kernel's order) equals the folded forward's eager expression
    ``_activate(y + _bias(b), act)`` bit for bit, over activation x dtype x
    channel count, on inputs above 20, below -20, zeros and subnormals;
  - the routing: a CPU tensor runs the plain version and launches nothing,
    an unsupported dtype raises naming it, ``apply_folded`` gives the bits
    of the eager forward it replaced (s2d stem on and off, float32 and
    bfloat16), the ``forward`` span counts 110 epilogues and 0 launches,
    a two-platform export holds no op of the port, a trace of the folded
    forward holds one ``conv_epilogue`` a conv and a CPU export none, with
    the live forward's bits;
  - ``tools.measure.epilogue_shapes``: the 110 shapes the card's checks
    use.

The kernel itself is checked against the plain version on the card
(tests/test_torch_epilogue_cuda.py, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_parity import IMG, SHALLOW, images
from yolov4tpu_torch import serving
from yolov4tpu_torch.api import Yolov4, build_infer_fn
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models import network, topology
from yolov4tpu_torch.ops import epilogue
from yolov4tpu_torch.tools.measure import epilogue_shapes
from yolov4tpu_torch.utils import profiling

ROWS = 64   # N*H*W of the model test's tensors: (2, C, 4, 8)


def rn(x, dtype):
    """Round float32 ``x`` to ``dtype`` (nearest even) and widen it back."""
    return x.to(dtype).float() if dtype == torch.bfloat16 else x


def kernel_model(y, b, activation):
    """csrc/conv_epilogue.cu's arithmetic, value by value on the (rows, C)
    view of channels_last ``y``: every step a float32 operation, rounded to
    ``y``'s dtype where the kernel rounds."""
    dt, c = y.dtype, y.shape[1]
    yf = y.permute(0, 2, 3, 1).reshape(-1, c).float()
    v = rn(yf + b.float(), dt)
    if activation == "mish":
        u = rn(torch.exp(torch.where(v > 20.0, 20.0, v)), dt)
        t1 = rn(u * u, dt)
        t2 = rn(2.0 * u, dt)
        n = rn(t1 + t2, dt)
        d = rn(n + 2.0, dt)
        q = rn(n / d, dt)
        p = rn(v * q, dt)
        out = torch.where(v > 20.0, v, p)
    elif activation == "leaky":
        out = torch.where(v > 0.0, v, rn(v * 0.1, dt))
    else:
        out = v
    n_, _, h, w = y.shape
    return out.to(dt).reshape(n_, h, w, c).permute(0, 3, 1, 2)


def conv_output(c, dtype, seed=0):
    """(2, c, 4, 8) channels_last ``y`` and (c,) ``b`` in ``dtype``: normal
    values at three scales, with values above 20 and below -20, zeros,
    negative zeros and subnormals of the dtype mixed in."""
    rng = np.random.default_rng(seed)
    y = rng.normal(0.0, 1.0, (ROWS, c)) * rng.choice([0.3, 4.0, 30.0],
                                                    (ROWS, c))
    tiny = float(torch.finfo(dtype).tiny)
    special = np.array([0.0, -0.0, 20.0, -20.0, 20.5, -20.5, 21.0, 88.0,
                        -100.0, tiny / 4, -tiny / 8, tiny * 0.75, 1e-30])
    idx = rng.choice(y.size, y.size // 6, replace=False)
    y.reshape(-1)[idx] = rng.choice(special, idx.size)
    b = rng.normal(0.0, 1.0, c) * rng.choice([0.1, 2.0], c)
    b[rng.choice(c, max(1, c // 8), replace=False)] = 0.0
    yt = torch.from_numpy(y.astype(np.float32)).to(dtype)
    yt = yt.reshape(2, 4, 8, c).permute(0, 3, 1, 2)      # channels_last
    assert yt.is_contiguous(memory_format=torch.channels_last)
    return yt, torch.from_numpy(b.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("c", (32, 255, 1024))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "f32"))
@pytest.mark.parametrize("activation", ("mish", "leaky", "linear"))
def test_kernel_model_equals_the_eager_expression(activation, dtype, c):
    y, b = conv_output(c, dtype, seed=c)
    want = network._activate(y + network._bias(b, dtype), activation)
    got = kernel_model(y, b, activation)
    assert got.dtype == want.dtype == dtype
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       want.contiguous(memory_format=torch.channels_last)
                       .view(torch.int16 if dtype == torch.bfloat16
                             else torch.int32))
    if activation == "mish":   # the inputs reach both sides of the clamp
        v = (y + network._bias(b, dtype)).float()
        assert bool((v > 20).any()) and bool((v < -20).any())


def test_cpu_tensor_runs_the_plain_version(monkeypatch):
    def no_kernel():
        raise AssertionError("the CUDA kernel was loaded for a CPU tensor")

    monkeypatch.setattr(epilogue, "_library", no_kernel)
    y, b = conv_output(64, torch.bfloat16)
    calls, launches = epilogue.CALLS, epilogue.LAUNCHES
    for act in ("mish", "leaky", "linear"):
        got = epilogue.conv_epilogue(y, b, act)
        assert torch.equal(got, epilogue.conv_epilogue_reference(y, b, act))
        # another layout on the CPU: the plain version too
        got = epilogue.conv_epilogue(y.contiguous(), b, act)
        assert torch.equal(got, epilogue.conv_epilogue_reference(y, b, act))
    assert epilogue.CALLS == calls + 6 and epilogue.LAUNCHES == launches


@pytest.mark.parametrize("dtype", (torch.float16, torch.float64))
def test_unsupported_dtype_raises_naming_it(dtype):
    y = torch.zeros(1, 8, 2, 2, dtype=dtype)
    with pytest.raises(TypeError, match=str(dtype)):
        epilogue.conv_epilogue(y, torch.zeros(8, dtype=dtype), "mish")
    y, b = conv_output(8, torch.bfloat16)
    with pytest.raises(TypeError, match="bias"):
        epilogue.conv_epilogue(y, b.float(), "mish")
    with pytest.raises(ValueError, match="activation"):
        epilogue.conv_epilogue(y, b, "relu")


class _EagerOps(network._FoldedApplyOps):
    """The folded forward's ops as they were before the epilogue op: the
    conv, then ``_activate(y + _bias)``; the s2d stem adding conv 1's bias
    before the skipped call's activation."""

    def _stem_pair_s2d(self, x, activation):
        w1p, b1p, w2p = self.params["s2d"]
        b, c, h, w = x.shape
        xb = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
        xb = xb.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        xb = network.cast(xb.permute(0, 3, 1, 2), self.dtype)
        y = F.conv2d(xb, network.cast(w1p, self.dtype), padding=1)
        y = network._activate(y + network._bias(b1p, self.dtype), activation)
        y = F.conv2d(F.pad(y, (1, 0, 1, 0)), network.cast(w2p, self.dtype))
        return y + network._bias(self.convs[1]["b"], self.dtype)

    def _epilogue(self, y, b, activation):
        return network._activate(y + network._bias(b, self.dtype),
                                 activation)

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        if self._skip_next:
            self._skip_next = False
            return network._activate(x, activation)
        return super().conv(x, filters, kernel_size, downsampling,
                            activation, batch_norm)


@pytest.fixture(scope="module")
def folded():
    """Full-depth folded params with random biases (init's are zero)."""
    params, state, _ = network.init(3, IMG, seed=4)
    folded = network.fold_bn(params, state)
    rng = np.random.default_rng(4)
    for p in folded["convs"]:
        p["b"] = torch.from_numpy(rng.normal(0.0, 0.5, p["b"].shape)
                                  .astype(np.float32))
    return folded


@pytest.mark.parametrize("s2d_stem", (True, False), ids=("s2d", "plain"))
@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32),
                         ids=("bf16", "f32"))
def test_apply_folded_gives_the_eager_forwards_bits(folded, dtype, s2d_stem):
    folded = network.prepare_folded(folded, "cpu", dtype)
    x = torch.from_numpy(images(4, 2).astype(np.float32) / 255.0)
    calls = epilogue.CALLS
    got = network.apply_folded(folded, x, 3, dtype, s2d_stem=s2d_stem)
    assert epilogue.CALLS == calls + 110
    ops = _EagerOps(folded, dtype, s2d_stem=s2d_stem)
    want = topology.yolov4(ops, x.permute(0, 3, 1, 2), 3,
                           topology.DEFAULT_CSP_REPEATS)
    want = [o.permute(0, 2, 3, 1).float().contiguous() for o in want]
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_forward_span_counts_the_epilogues(tiny_classes):
    model = Yolov4(None, tiny_classes, device="cpu",
                   config=YoloConfig(img_size=(IMG, IMG, 3),
                                     nms_pre_top_k=64))
    profiling.clear_spans()
    try:
        with profiling.recording():
            model.predict_batch(images(5, 2))
        (forward,) = [s for s in profiling.spans() if s.name == "forward"]
    finally:
        profiling.clear_spans()
    assert forward.counts == {"convs": 110, "epilogue_launches": 0,
                              "merges": 0}


def _port_ops(program):
    return [str(n.target) for n in program.graph.nodes
            if n.op == "call_function"
            and str(n.target).startswith("yolov4tpu_torch")]


@pytest.fixture(scope="module")
def xla_model(tiny_classes):
    return Yolov4(None, tiny_classes, device="cpu",
                  config=YoloConfig(img_size=(IMG, IMG, 3),
                                    csp_repeats=SHALLOW, nms_impl="xla",
                                    nms_pre_top_k=16))


def test_two_platform_export_holds_no_op_of_the_port(xla_model, tmp_path):
    exported = serving.export_detector(xla_model, str(tmp_path / "m.pt2"),
                                       platforms=("cuda", "cpu"))
    assert _port_ops(exported) == []


def test_the_folded_forward_traces_through_the_op(xla_model, tmp_path):
    """Traced (as a single-platform CUDA export is), the program holds one
    ``conv_epilogue`` a conv; a CPU export replaces each by the plain
    version and gives the live facade's bits."""
    m = xla_model
    n_convs = len(m._folded["convs"])
    x = torch.from_numpy(images(6, 1).astype(np.float32) / 255.0)
    fn = build_infer_fn(m.config, m.num_classes, m._compute_dtype)

    class Detector(torch.nn.Module):
        def forward(self, images):
            return tuple(fn(m._folded, images, 0.4, 0.3))

    exported = torch.export.export(Detector(), (x,), strict=False)
    assert _port_ops(exported) == (["yolov4tpu_torch.conv_epilogue.default"]
                                   * n_convs)
    served = serving.export_detector(m, str(tmp_path / "cpu.pt2"),
                                     platforms=("cpu",),
                                     iou_threshold=0.4, score_threshold=0.3)
    assert _port_ops(served) == []
    detect = serving.load_detector(str(tmp_path / "cpu.pt2"), device="cpu")
    want = m.predict_batch(x, iou_threshold=0.4, score_threshold=0.3)
    for g, w in zip(detect(x), want):
        assert torch.equal(g, w)


def test_epilogue_shapes_of_the_416_b64_forward():
    shapes = epilogue_shapes(416, 64)
    acts = [a for _, a in shapes]
    assert len(shapes) == 110
    assert (acts.count("mish"), acts.count("leaky"),
            acts.count("linear")) == (70, 37, 3)
    assert shapes[0] == ((64, 128, 208, 208), "leaky")      # s2d stem conv 0
    assert shapes[1] == ((64, 64, 208, 208), "leaky")       # conv 1
    assert [s for s, a in shapes if a == "linear"] == [
        (64, 255, 52, 52), (64, 255, 26, 26), (64, 255, 13, 13)]
    elems = sum(int(np.prod(s)) for s, _ in shapes)
    assert elems * 2 == 6_855_332_224      # bf16 bytes of one pass
