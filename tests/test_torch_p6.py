"""YOLOv4-P6 (Scaled-YOLOv4, ``config.arch="yolov4-p6"``) on the CPU,
against the benchmark's plain reference (perfbench/reference/
scaled_yolov4.py: float32 torch, BN unfolded, the Detect's decode):

  - the graph at 80 classes: 205 convs (19 plain, 4 heads of 340
    channels), 13 concat norms, 7 second stages, 127,590,576 parameters,
    strides 8-64; the serial order is the reference's, shape for shape;
  - ``apply`` (BN inference) and ``fold_bn`` + ``apply_folded`` in float32
    equal the reference's forward within float32's accumulation error,
    which a bfloat16 forward exceeds;
  - the second epilogue mode's plain version is the eager chain, and a
    model of the kernel's roundings equals it bit for bit, in bf16 and
    f32;
  - ``predict_batch`` serves the reference's exact greedy NMS over its
    candidate cut, and its ``forward`` span counts every conv's epilogue,
    7 of them merges (YOLOv4's 110 and 0: tests/test_torch_epilogue.py);
  - the facade's paths that run the YOLOv4 graph only raise for P6.

128 px, one Bottleneck a stage where depth is not the subject.  The
kernel itself is checked on the card (tests/test_torch_p6_cuda.py).
"""

import numpy as np
import pytest
import torch

from perfbench.reference import nms as ref_nms
from perfbench.reference import scaled_yolov4 as ref
from test_torch_epilogue import conv_output, rn
from yolov4tpu_torch import serving
from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import P6_DEPTH, p6_config
from yolov4tpu_torch.models import network
from yolov4tpu_torch.ops import epilogue
from yolov4tpu_torch.train import Trainer
from yolov4tpu_torch.utils import profiling

SIDE = 128
ONE = (1,) * 7
P6 = "yolov4-p6"
# float32 against float32 through ~200 layers of different summation
# orders reads ~1e-6 of the output's scale (a CPU run); a bf16 forward
# ~5e-3.  1e-4 holds the first with 100x room and fails the second.
F32_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def weights():
    return ref.make(7, 80, "cpu", ONE)


@pytest.fixture(scope="module")
def image():
    return torch.rand((1, SIDE, SIDE, 3),
                      generator=torch.Generator().manual_seed(3))


@pytest.fixture(scope="module")
def reference(weights, image):
    return ref.forward(*weights, image, 80, depth=ONE)


def test_graph_counts_at_80_classes():
    specs = network.conv_specs(80, P6_DEPTH, P6)
    plain = [s for s in specs if not s.batch_norm and s.norm is not None]
    heads = [s for s in specs if not s.batch_norm and s.norm is None]
    sites = {s.norm[0] for s in specs if s.norm is not None}
    widths = {}
    for s in specs:
        if s.norm is not None:
            widths[s.norm[0]] = widths.get(s.norm[0], 0) + s.filters
    n = sum(s.in_ch * s.filters * s.kernel_size ** 2
            + (2 * s.filters if s.batch_norm else
               s.filters * (s.norm is None))
            for s in specs) + 2 * sum(widths.values())
    assert (len(specs), len(plain), len(heads)) == (205, 19, 4)
    assert [h.filters for h in heads] == [340] * 4
    assert len(sites) == 13 and sum(s.merge for s in specs) == 7
    assert all(s.norm is not None for s in plain)
    assert n == 127_590_576
    assert p6_config().strides == (8, 16, 32, 64)
    assert p6_config().anchors_grouped.shape == (4, 4, 2)
    assert ref.model_flops(1280) == pytest.approx(717.02e9, rel=1e-5)


def _gap(outs, want):
    return max(float((o - w).abs().max() / w.abs().max())
               for o, w in zip(outs, want))


def test_forwards_equal_the_unfolded_reference(weights, image, reference):
    params, state = weights
    outs, _ = network.apply(params, state, image, 80, csp_repeats=ONE,
                            arch=P6)
    folded = network.fold_bn(params, state, network.conv_specs(80, ONE, P6))
    assert sum("s" in p for p in folded["convs"]) == 7
    f32 = network.apply_folded(network.prepare_folded(folded, "cpu"), image,
                               80, csp_repeats=ONE, arch=P6)
    bf16 = network.apply_folded(
        network.prepare_folded(folded, "cpu", torch.bfloat16), image, 80,
        torch.bfloat16, csp_repeats=ONE, arch=P6)
    assert [tuple(o.shape) for o in f32] == [
        (1, SIDE // s, SIDE // s, 340) for s in (8, 16, 32, 64)]
    assert _gap(outs, reference) < F32_TOL
    assert _gap(f32, reference) < F32_TOL
    assert _gap(bf16, reference) > F32_TOL


def merge_model(y, b, s, t):
    """csrc/conv_epilogue.cu's second mode, value by value: float32
    operations rounded to y's dtype where the kernel rounds."""
    dt, c = y.dtype, y.shape[1]
    yf = y.permute(0, 2, 3, 1).reshape(-1, c).float()

    def mish(v):
        u = rn(torch.exp(torch.where(v > 20.0, 20.0, v)), dt)
        n = rn(rn(u * u, dt) + rn(2.0 * u, dt), dt)
        q = rn(n / rn(n + 2.0, dt), dt)
        return torch.where(v > 20.0, v, rn(v * q, dt))

    m = mish(rn(yf + b.float(), dt))
    out = mish(rn(rn(m * s.float(), dt) + t.float(), dt))
    n_, _, h, w = y.shape
    return out.to(dt).reshape(n_, h, w, c).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", (torch.bfloat16, torch.float32))
@pytest.mark.parametrize("c", (8, 12, 340))
def test_merge_plain_version_is_the_eager_chain(dtype, c):
    y, b = conv_output(c, dtype, seed=c)
    _, s = conv_output(c, dtype, seed=c + 1)
    _, t = conv_output(c, dtype, seed=c + 2)
    s = s.abs() + 0.5
    mish = epilogue._mish
    chain = mish(mish(y + b.view(1, -1, 1, 1)) * s.view(1, -1, 1, 1)
                 + t.view(1, -1, 1, 1))
    got = epilogue.conv_epilogue_merge(y, b, s, t)
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16
                                else torch.int32),
                       chain.view(torch.int16 if dtype == torch.bfloat16
                                  else torch.int32))
    model = merge_model(y, b, s, t)
    assert torch.equal(model, chain) or torch.equal(
        torch.nan_to_num(model), torch.nan_to_num(chain))


@pytest.fixture(scope="module")
def classes(tmp_path_factory):
    path = tmp_path_factory.mktemp("p6") / "classes.txt"
    path.write_text("".join(f"c{i}\n" for i in range(80)))
    return str(path)


def _shapes(tree):
    return [{k: tuple(v.shape) for k, v in p.items()} for p in tree]


@pytest.fixture(scope="module")
def p6_model(classes, weights):
    """A P6 facade at 128 px; ``init_shapes``: its own init's params'
    shapes, before it takes the reference's weights."""
    model = Yolov4(None, classes, device="cpu", config=p6_config(
        img_size=(SIDE, SIDE, 3), csp_repeats=ONE, nms_pre_top_k=64))
    model.init_shapes = (_shapes(model.params["convs"]),
                         _shapes(model.params["norms"]),
                         [s is None for s in model.state["bn"]])
    model.sync_params(*weights)
    return model


def test_serial_order_is_the_references(p6_model, weights):
    convs, norms = ref.trace(SIDE)
    specs = network.conv_specs(80, P6_DEPTH, P6)
    kind = {"conv": (True, False), "plain": (False, False),
            "head": (False, True)}
    assert [(s.in_ch, s.filters, s.kernel_size,
             2 if s.downsampling else 1,
             (s.batch_norm, not s.batch_norm and s.norm is None))
            for s in specs] == [(c["ci"], c["co"], c["k"], c["s"],
                                 kind[c["kind"]]) for c in convs]
    assert [n["c"] for n in norms] == [
        sum(s.filters for s in specs if s.norm and s.norm[0] == j)
        for j in range(len(norms))]
    params, state = weights
    assert p6_model.init_shapes == (_shapes(params["convs"]),
                                    _shapes(params["norms"]),
                                    [s is None for s in state["bn"]])


def _recorded_forward(model, imgs, **kw):
    profiling.clear_spans()
    try:
        with profiling.recording():
            out = model.predict_batch(imgs, **kw)
        (forward,) = [s for s in profiling.spans() if s.name == "forward"]
    finally:
        profiling.clear_spans()
    return out, forward.counts


def test_predict_batch_serves_the_references_nms(p6_model, image,
                                                 reference):
    rb, rs = ref.decode(reference, 80, SIDE)
    # A score threshold in the widest gap between the 20th to 60th best
    # (anchor, class) scores, so that no pair sits near it.
    top = torch.sort(rs.flatten(), descending=True).values[19:61]
    k = int(torch.argmax(top[:-1] - top[1:]))
    score_t = float(top[k] + top[k + 1]) / 2
    assert float(top[k] - top[k + 1]) > 1e-4
    (boxes, scores, cls, valid), counts = _recorded_forward(
        p6_model, image, iou_threshold=0.5, score_threshold=score_t)
    want = ref_nms.serve(rb, rs, 0.5, score_t, 100, 64)
    assert counts == {"convs": len(network.conv_specs(80, ONE, P6)),
                      "epilogue_launches": 0, "merges": 7}
    n = int(valid[0])
    assert n == int(want[3][0]) > 0
    assert cls[0, :n].tolist() == want[2][0, :n].tolist()
    np.testing.assert_allclose(boxes[0, :n].numpy(), want[0][0, :n],
                               atol=1e-4)
    np.testing.assert_allclose(scores[0, :n].numpy(), want[1][0, :n],
                               atol=1e-4)


UNSUPPORTED = {
    "trainer": lambda m, tmp: m.trainer(),
    "Trainer": lambda m, tmp: Trainer(m.config, 80, m.params, m.state,
                                      device="cpu"),
    "quantize": lambda m, tmp: m.quantize(
        calib_imgs=np.zeros((1, 64, 64, 3), np.float32)),
    "distribute": lambda m, tmp: m.distribute(1),
    "export_serving": lambda m, tmp: serving.export_detector(
        m, str(tmp / "m.pt2")),
    "save_model": lambda m, tmp: m.save_model(str(tmp / "w.weights")),
    "load_model": lambda m, tmp: m.load_model(str(tmp / "w.npz")),
    "weight_file": lambda m, tmp: Yolov4(
        str(tmp / "w.weights"), m.classes_path, device="cpu",
        config=m.config),
}


@pytest.mark.parametrize("path", sorted(UNSUPPORTED))
def test_unsupported_paths_raise_naming_the_arch(p6_model, classes, path,
                                                 tmp_path):
    p6_model.classes_path = classes
    with pytest.raises(NotImplementedError, match="yolov4-p6"):
        UNSUPPORTED[path](p6_model, tmp_path)
