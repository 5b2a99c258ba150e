"""The port's int8 post-training quantization (``models/quantize.py`` and
``Yolov4.quantize``) against the JAX package's, on the same folded params
and images.

Exact where the arithmetic is: the int8 weights and their scales, the int32
accumulators of the int8 GEMM, the int8 shape ops.  Calibration scales agree
to float rounding; the whole int8 forward to rel-RMS 1e-2 at float32, and to
the JAX test's detection level at bfloat16.  The facade's ``quantize`` is
in test_torch_quantize_facade.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from _torch_parity import (IMG, SHALLOW, images, jax_fold_bn, rel_rms,
                           well_conditioned)
from yolov4tpu.models import quantize as jq
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models import network, quantize as tq
from yolov4tpu_torch.ops.detect import detect_fused

C = 3


@pytest.fixture(scope="module")
def setup():
    """The JAX folded params (numpy, HWIO) and the same in the port's
    layout, four images, and the JAX package's max-abs calibration and int8
    params of them (float32)."""
    jf = jax.tree.map(np.asarray, jax_fold_bn(*well_conditioned(C)))
    tf = {"convs": [{"w": torch.from_numpy(
                         np.ascontiguousarray(p["w"].transpose(3, 2, 0, 1))),
                     "b": torch.from_numpy(p["b"])} for p in jf["convs"]]}
    imgs = images(0, 4).astype(np.float32) / 255.0
    scales = jq.calibrate(jf, imgs, C, jnp.float32, SHALLOW, batch_size=2)
    jqp = jax.tree.map(np.asarray, jq.quantize_folded(jf, scales, C, SHALLOW))
    return jf, tf, imgs, scales, jqp


def test_weights_bit_equal_to_jax(setup):
    """quantize_folded: wq, sw and b equal the JAX package's bit for bit
    after HWIO -> OIHW, the same convs are eligible (stem pair and heads
    stay float), and qparams_to_jax inverts qparams_from_jax."""
    jf, tf, _, scales, jqp = setup
    got = tq.quantize_folded(tf, scales, C, SHALLOW)
    specs = network.conv_specs(C, SHALLOW)
    assert [("wq" in p) for p in got["convs"]] == \
        [("wq" in p) for p in jqp["convs"]] == \
        [tq._eligible(s.index, s.batch_norm) for s in specs]
    assert sum("wq" in p for p in got["convs"]) == len(specs) - 5
    back = tq.qparams_to_jax(got)
    for g, w in zip(back["convs"], jqp["convs"]):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k])
    for k in scales:
        np.testing.assert_array_equal(back["scales"][k], scales[k])
    again = tq.qparams_to_jax(tq.qparams_from_jax(jqp))
    for g, w in zip(again["convs"], jqp["convs"]):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("method,dtype,rtol", [
    ("max", "float32", 1e-4),
    ("percentile", "float32", 1e-4),
    ("max", "bfloat16", 4 * 2.0 ** -8),
])
def test_calibration_matches_jax(setup, method, dtype, rtol):
    """calibrate: every conv-input, conv-output and add-output scale, two
    batches of two images (the elementwise max over batches).  The first
    convs' tensors hold 2x64x64x32 > 65,536 elements, so the percentile
    runs on the strided subsample, taken in NHWC order as the JAX package
    takes it.  In bfloat16 the two conv libraries round the forward apart
    (test_torch_network.py holds the bf16 forward to 4 bf16 ulps of its
    largest magnitude); a scale is a tensor's largest magnitude, so it is
    held to 4 ulps of itself.  Measured: 8 of 74 conv-input scales differ,
    the most by 1.24e-2."""
    jf, tf, imgs, max_f32, _ = setup
    if method == "max" and dtype == "float32":
        want = max_f32
    else:
        want = jq.calibrate(jf, imgs, C, getattr(jnp, dtype), SHALLOW,
                            batch_size=2, method=method)
    got = tq.calibrate(tf, imgs, C, getattr(torch, dtype), SHALLOW,
                       batch_size=2, method=method)
    assert sorted(got) == ["add_out", "conv_in", "conv_out"]
    for k in want:
        assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0)


def test_calibration_raises_as_jax(setup):
    _, tf, imgs, _, _ = setup
    with pytest.raises(ValueError, match="'max' or 'percentile'"):
        tq.calibrate(tf, imgs, C, torch.float32, SHALLOW, method="entropy")
    with pytest.raises(ValueError, match="percentile must be"):
        tq.calibrate(tf, imgs, C, torch.float32, SHALLOW,
                     method="percentile", percentile=0.0)


@pytest.mark.parametrize("b,h,w,ci,co,k,down", [
    (1, 2, 2, 16, 8, 1, False),     # 4 rows: padded to the card's 17
    (2, 7, 9, 8, 16, 3, False),     # 3x3 stride 1, SAME
    (2, 7, 10, 16, 24, 3, True),    # darknet downsample, odd height
])
def test_int8_conv_accumulators_exact(b, h, w, ci, co, k, down):
    """int8_conv's int32 accumulators equal
    lax.conv_general_dilated(preferred_element_type=int32), the JAX
    package's int8 conv, exactly."""
    rng = np.random.default_rng(b * 100 + k)
    x = rng.integers(-127, 128, (b, h, w, ci), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, ci, co), dtype=np.int8)
    stride, padding = (2, ((1, 0), (1, 0))) if down else (1, "SAME")
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(wq), (stride, stride), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    q = torch.from_numpy(x).permute(0, 3, 1, 2)      # NCHW, channels_last
    w_oihw = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    got, shape = tq.int8_conv(q, w_oihw, k, down)
    assert got.dtype == torch.int32 and shape == want.shape[:3]
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)
    # The prepared GEMM layout gives the same accumulators.
    again, _ = tq.int8_conv(q, tq.gemm_weight(w_oihw), k, down)
    assert torch.equal(again, got)


def _qvals(rng, shape, scale, n=1):
    x = [rng.integers(-127, 128, shape, dtype=np.int8) for _ in range(n)]
    return ([jq._QVal(jnp.asarray(a), s) for a, s in zip(x, scale)],
            [tq._QVal(torch.from_numpy(a).permute(0, 3, 1, 2), s)
             for a, s in zip(x, scale)])


@pytest.mark.parametrize("op", ["maxpool", "upsample", "concat", "add"])
def test_int8_shape_ops_exact(op):
    """_QuantizedFlowOps' int8 max pool (SAME, -128 padding), nearest
    upsample, concat rebinning and residual add-requantize equal the JAX
    package's on the same _QVal inputs, at float32."""
    rng = np.random.default_rng(5)
    scales = {"conv_in": np.ones(1, np.float32),
              "conv_out": np.ones(1, np.float32),
              "add_out": np.float32([0.037])}
    jops = jq._QuantizedFlowOps({"convs": []}, scales, jnp.float32)
    tops = tq._QuantizedFlowOps({"convs": []}, scales, torch.float32)
    s = [float(np.float32(v)) for v in (0.02, 0.031, 0.0123)]
    if op == "maxpool":
        (ja,), (ta,) = _qvals(rng, (2, 13, 13, 8), s)
        want, got = jops.maxpool(ja, 5), tops.maxpool(ta, 5)
    elif op == "upsample":
        (ja,), (ta,) = _qvals(rng, (2, 3, 5, 8), s)
        want, got = jops.upsample(ja), tops.upsample(ta)
    elif op == "concat":
        ja, ta = _qvals(rng, (2, 4, 4, 8), s, 3)
        want, got = jops.concat(ja), tops.concat(ta)
    else:
        ja, ta = _qvals(rng, (2, 4, 4, 8), s, 2)
        want, got = jops.add(*ja), tops.add(*ta)
    assert got.q.dtype == torch.int8 and got.scale == want.scale
    np.testing.assert_array_equal(got.q.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want.q))


@functools.lru_cache(maxsize=None)
def _jax_apply(dataflow, dtype, scales_key):
    scales = dict(scales_key)
    return jax.jit(functools.partial(
        jq.apply_quantized, num_classes=C, compute_dtype=dtype,
        csp_repeats=SHALLOW, s2d_stem=False,
        scales={k: np.asarray(v, np.float32) for k, v in scales.items()},
        dataflow=dataflow))


def _jax_raws(jqp, scales, imgs, dataflow, dtype):
    key = tuple((k, tuple(v.tolist())) for k, v in sorted(scales.items()))
    fn = _jax_apply(dataflow, dtype, key)
    return [np.asarray(o) for o in fn({"convs": jqp["convs"]},
                                      jnp.asarray(imgs))]


@pytest.mark.parametrize("dataflow", ["int8", "bf16"])
def test_apply_quantized_matches_jax(setup, dataflow):
    """apply_quantized on qparams_from_jax of the JAX int8 params and
    scales, float32, s2d stem off: the raw grids within rel-RMS 1e-2 of
    the JAX package's.  Measured here: 2.9e-7 / 3.1e-7 / 0 on the three
    grids (int8 dataflow) and 3.1e-7 / 3.3e-7 / 0 (bf16 dataflow); over
    the int8 dataflow's 69 conv outputs, 0 of 3,330,048 int8 elements differ
    (the float32 epilogues round alike; the convs' float sums do not)."""
    _, _, imgs, scales, jqp = setup
    want = _jax_raws(jqp, scales, imgs, dataflow, jnp.float32)
    qp = network.prepare_folded(tq.qparams_from_jax(jqp), "cpu")
    got = tq.apply_quantized(qp, torch.from_numpy(imgs), C, torch.float32,
                             SHALLOW, s2d_stem=False, scales=scales,
                             dataflow=dataflow)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        assert rel_rms(g.numpy(), w) < 1e-2


def _iou(a, b):
    y1, x1 = np.maximum(a[:2], b[:2])
    y2, x2 = np.minimum(a[2:], b[2:])
    inter = max(0.0, y2 - y1) * max(0.0, x2 - x1)
    area = ((a[2] - a[0]) * (a[3] - a[1])
            + (b[2] - b[0]) * (b[3] - b[1]) - inter)
    return inter / max(area, 1e-9)


def assert_detections_agree(ref, other):
    """The JAX package's detection-level contract for int8
    (tests/test_quantize.py:128-173): counts within max(3, 25%), and at
    least 80% of the confident reference boxes (score >= 0.10) have a
    same-class counterpart at IoU > 0.5."""
    bf, sf, cf, vf = [o.numpy() for o in ref]
    bq, _, cq, vq = [o.numpy() for o in other]
    checked = matched = 0
    for i in range(len(vf)):
        nf, nq = int(vf[i]), int(vq[i])
        assert abs(nf - nq) <= max(3, int(0.25 * max(nf, nq)))
        for j in range(nf):
            if sf[i, j] < 0.10:
                continue
            checked += 1
            matched += any(cf[i, j] == cq[i, k]
                           and _iou(bf[i, j], bq[i, k]) > 0.5
                           for k in range(nq))
    assert checked > 0, "no confident detections"
    assert matched / checked >= 0.8, f"{matched}/{checked} matched"


def test_bf16_detections_agree_with_jax_and_float(setup):
    """At bfloat16 (scales calibrated in bfloat16, as the facade does) the
    int8 forward's detections (the port's fused decode and NMS, score 0.05)
    agree with the JAX package's int8 forward (float32) and with the
    port's own bfloat16 float forward, to the JAX test's detection level."""
    _, tf, imgs, scales, jqp = setup
    cfg = YoloConfig(img_size=(IMG, IMG, 3), csp_repeats=SHALLOW)

    def detect(raws):
        return detect_fused([torch.as_tensor(r) for r in raws],
                            cfg.anchors_grouped, C, cfg.strides,
                            cfg.xyscale, IMG, iou_threshold=0.45,
                            score_threshold=0.05)

    x = torch.from_numpy(imgs)
    bf16 = tq.calibrate(tf, imgs, C, torch.bfloat16, SHALLOW)
    q = network.prepare_folded(tq.quantize_folded(tf, bf16, C, SHALLOW),
                               "cpu", torch.bfloat16)
    got = detect(tq.apply_quantized(q, x, C, torch.bfloat16, SHALLOW,
                                    s2d_stem=False))
    jax_int8 = detect(_jax_raws(jqp, scales, imgs, "int8", jnp.float32))
    floats = detect(network.apply_folded(
        network.prepare_folded(tf, "cpu", torch.bfloat16), x, C,
        torch.bfloat16, SHALLOW, s2d_stem=False))
    assert_detections_agree(jax_int8, got)
    assert_detections_agree(floats, got)


def test_s2d_stem_on_vs_off(setup):
    """The stem convs stay float, so the s2d stem composes with the int8
    path; its float reassociation may flip an int8 bin downstream, so the
    contract is closeness (rel-RMS < 0.05, as the JAX package's test)."""
    _, tf, imgs, scales, _ = setup
    qp = network.prepare_folded(tq.quantize_folded(tf, scales, C, SHALLOW),
                                "cpu")
    x = torch.from_numpy(imgs)
    off = tq.apply_quantized(qp, x, C, torch.float32, SHALLOW, s2d_stem=False)
    on = tq.apply_quantized(qp, x, C, torch.float32, SHALLOW, s2d_stem=True)
    assert "s2d" in qp
    for a, b in zip(off, on):
        assert rel_rms(b.numpy(), a.numpy()) < 0.05


def test_scale_mismatch_raises(setup):
    _, tf, _, scales, _ = setup
    short = dict(scales, conv_in=scales["conv_in"][:-1])
    with pytest.raises(ValueError, match="act_scales cover"):
        tq.quantize_folded(tf, short, C, SHALLOW)
