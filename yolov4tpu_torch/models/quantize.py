"""Post-training int8 quantization for the inference path.

Counterpart of ``yolov4tpu.models.quantize``.  It turns the BN-folded
inference params (``network.fold_bn``) into an int8 program.  Two dataflows
share one calibration:

- ``dataflow="bf16"``: tensors BETWEEN ops stay in the compute dtype; each
  eligible conv quantizes its input in its prologue and dequantizes in its
  epilogue.
- ``dataflow="int8"`` (default): tensors between ops are int8 with a STATIC
  per-tensor scale.  Conv epilogues requantize straight to the output
  tensor's calibrated scale, consumers take int8 input with no prologue,
  max pool and upsample run on int8 (monotone ops and data movement commute
  with symmetric quantization), concat rebins its branches to the largest
  branch scale, residual adds dequantize, add and requantize.

Scales: weights per output channel, symmetric (max|w[c]| / 127);
activations per tensor, symmetric, STATIC, calibrated by running
representative images through the float folded model and recording each
conv's input and output and each residual add's output max-abs
(``calibrate``).  The two stem convs and the three bias-carrying head convs
stay in float, as in the JAX package.

The int8 conv is a GEMM: ``torch._int_mm`` (int8 x int8 -> int32), over the
(B*H*W, Ci) activation matrix for a 1x1 conv and over an im2col of the
zero-padded int8 NHWC tensor for a 3x3 one (the zero point is 0, so the
zero padding is exact).  The JAX package leaves the same product to XLA
(``lax.conv_general_dilated(..., preferred_element_type=int32)``), outside
any Pallas kernel, so the int32 accumulators are equal on the CPU.  On the
card ``_int_mm`` takes more than 16 rows only, so smaller products are
padded with zero rows.  Epilogues follow the JAX arithmetic op for op, so
the same int8 inputs give the same int8 outputs at float32.

Accuracy is validated at the detection level (int8 is an opt-in speed
path and does not meet the float path's 1e-3 per-box contract).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from . import topology
from .network import _activate, _FoldedApplyOps, cast, conv_specs

# Symmetric int8 range, -127..127 (not -128), as the JAX package uses.
QMAX = 127.0
# torch._int_mm on the card takes more than 16 rows.
_MIN_ROWS = 17


def _eligible(index: int, batch_norm: bool) -> bool:
    """Quantize every BN conv except the two stem convs; the head convs
    (batch_norm=False in the topology) stay high-precision."""
    return batch_norm and index >= 2


# ---------------------------------------------------------------------------
# Calibration: record per-tensor max-abs through the folded forward
# ---------------------------------------------------------------------------

class _CalibApplyOps(_FoldedApplyOps):
    """Folded apply that records max|x| (or a quantile of |x|) of every conv
    input and output and every residual-add output, in traversal order.
    Runs with the s2d stem off, so the conv records are one per conv in
    serial order."""

    def __init__(self, params, compute_dtype=torch.float32,
                 quantile: Optional[float] = None):
        super().__init__(params, compute_dtype, s2d_stem=False)
        self.conv_in: List[torch.Tensor] = []
        self.conv_out: List[torch.Tensor] = []
        self.add_out: List[torch.Tensor] = []
        # None -> exact max-abs; q in (0, 1] -> that quantile of |x|.
        self.quantile = quantile

    def _amax(self, x):
        ax = x.abs().float()
        if self.quantile is None:
            return ax.max()
        # The JAX package subsamples the NHWC array in memory order; the
        # activations here are NCHW views of NHWC memory, so flatten them
        # in NHWC order to pick the same elements.
        flat = ax.permute(0, 2, 3, 1).reshape(-1)
        if flat.numel() > 65536:
            flat = flat[::-(-flat.numel() // 65536)]
        return torch.quantile(flat, self.quantile)

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        self.conv_in.append(self._amax(x))
        y = super().conv(x, filters, kernel_size, downsampling=downsampling,
                         activation=activation, batch_norm=batch_norm)
        self.conv_out.append(self._amax(y))
        return y

    def add(self, a, b):
        y = super().add(a, b)
        self.add_out.append(self._amax(y))
        return y


def calibrate(folded_params, images, num_classes: int,
              compute_dtype=torch.bfloat16,
              csp_repeats=topology.DEFAULT_CSP_REPEATS,
              batch_size: int = 8, method: str = "max",
              percentile: float = 99.9) -> Dict[str, np.ndarray]:
    """Per-tensor activation scales from representative images.

    folded_params: folded params (``fold_bn``, or ``prepare_folded`` of
    it), on the device the calibration runs on.  images: (N, H, W, 3) float
    [0, 1].  Returns float32 arrays ``{"conv_in": (n_convs,), "conv_out":
    (n_convs,), "add_out": (n_adds,)}``, the elementwise max over batches
    of ``batch_size`` of max|tensor| / 127 (``method="max"``) or of the
    ``percentile`` quantile of |tensor| / 127 (``method="percentile"``;
    taken per batch).
    """
    if method == "max":
        q = None
    elif method == "percentile":
        if not 0.0 < percentile <= 100.0:
            raise ValueError(f"percentile must be in (0, 100], "
                             f"got {percentile}")
        q = percentile / 100.0
    else:
        raise ValueError(
            f"method must be 'max' or 'percentile', got {method!r}")
    device = folded_params["convs"][0]["w"].device
    images = np.asarray(images, np.float32)
    amax = None
    with torch.inference_mode():
        for s in range(0, len(images), batch_size):
            ops = _CalibApplyOps(folded_params, compute_dtype, quantile=q)
            x = torch.from_numpy(images[s:s + batch_size]).to(device)
            topology.yolov4(ops, x.permute(0, 3, 1, 2), num_classes,
                            csp_repeats)
            rec = [torch.stack(r).cpu().numpy() if r else
                   np.zeros((0,), np.float32)
                   for r in (ops.conv_in, ops.conv_out, ops.add_out)]
            amax = rec if amax is None else [np.maximum(a, b)
                                             for a, b in zip(amax, rec)]

    def to_scale(a):
        # All-zero tensors (a dead calibration set) get scale 1.
        a = np.where(a > 0, a, QMAX)
        return (a / QMAX).astype(np.float32)

    return {"conv_in": to_scale(amax[0]), "conv_out": to_scale(amax[1]),
            "add_out": to_scale(amax[2])}


# ---------------------------------------------------------------------------
# Weight quantization
# ---------------------------------------------------------------------------

def quantize_folded(folded_params, act_scales: Dict[str, np.ndarray],
                    num_classes: int,
                    csp_repeats=topology.DEFAULT_CSP_REPEATS):
    """Folded params + calibrated activation scales -> int8 params.

    Eligible convs become ``{"wq": int8 OIHW, "b": float32, "sw": float32
    (Co,)}`` (per-output-channel weight scales, computed in numpy float32
    as the JAX package does, so ``wq`` and ``sw`` are bit-equal to its own
    after HWIO -> OIHW); the rest keep their float ``{"w", "b"}``.  CPU
    tensors; the activation scales ride along as ``qparams["scales"]``.
    """
    specs = conv_specs(num_classes, tuple(csp_repeats))
    n = len(specs)
    if len(act_scales["conv_in"]) != n or len(act_scales["conv_out"]) != n:
        raise ValueError(
            f"act_scales cover {len(act_scales['conv_in'])} convs, "
            f"topology has {n}")
    out = []
    for spec, p in zip(specs, folded_params["convs"]):
        if not _eligible(spec.index, spec.batch_norm):
            out.append({"w": p["w"], "b": p["b"]})
            continue
        w = p["w"].detach().to("cpu", torch.float32).numpy()   # OIHW
        sw = np.max(np.abs(w), axis=(1, 2, 3)) / QMAX           # per out-ch
        sw = np.where(sw > 0, sw, 1.0).astype(np.float32)
        wq = np.clip(np.rint(w / sw[:, None, None, None]),
                     -QMAX, QMAX).astype(np.int8)
        out.append({"wq": torch.from_numpy(wq),
                    "b": p["b"].detach().to("cpu", torch.float32),
                    "sw": torch.from_numpy(sw)})
    return {"convs": out,
            "scales": {k: np.asarray(v, np.float32)
                       for k, v in act_scales.items()}}


def gemm_weight(wq):
    """int8 kernel -> the GEMM's weight matrix (Co, kh*kw*Ci), rows in the
    im2col's (ky, kx, ci) order; a matrix already in that layout is kept."""
    if wq.dim() == 2:
        return wq
    co = wq.shape[0]
    return wq.permute(0, 2, 3, 1).reshape(co, -1).contiguous()


def qparams_from_jax(qparams):
    """The JAX package's quantized pytree (numpy; HWIO kernels, int8 ``wq``)
    -> the port's (CPU tensors, OIHW)."""
    convs = []
    for p in qparams["convs"]:
        q = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
        for k in ("w", "wq"):
            if k in q:
                q[k] = q[k].permute(3, 2, 0, 1).contiguous()
        convs.append(q)
    return {"convs": convs,
            "scales": {k: np.asarray(v, np.float32)
                       for k, v in qparams["scales"].items()}}


def qparams_to_jax(qparams):
    """The inverse of ``qparams_from_jax``: ``quantize_folded``'s params
    (OIHW) -> the JAX package's pytree of numpy arrays (HWIO)."""
    convs = []
    for p in qparams["convs"]:
        q = {}
        for k, v in p.items():
            v = v.detach().cpu()
            if k in ("w", "wq"):
                v = v.permute(2, 3, 1, 0)
            q[k] = v.contiguous().numpy()
        convs.append(q)
    return {"convs": convs,
            "scales": {k: np.asarray(v, np.float32)
                       for k, v in qparams["scales"].items()}}


# ---------------------------------------------------------------------------
# The int8 conv: im2col + torch._int_mm
# ---------------------------------------------------------------------------

def _quantize(x, scale: float):
    """Static-scale symmetric quantization, as the JAX package rounds it:
    round(x * (1/scale)) (half to even), clipped to +-127, int8."""
    return torch.clamp(torch.round(cast(x, torch.float32) * (1.0 / scale)),
                       -QMAX, QMAX).to(torch.int8)


def int8_conv(q, wq, kernel_size: int, downsampling: bool = False):
    """int8 NCHW activations ``q`` (channels_last memory) x int8 weights
    ``wq`` (OIHW or ``gemm_weight``'s matrix) -> the int32 accumulators as
    an (B*Ho*Wo, Co) matrix in NHWC order, and (B, Ho, Wo).

    SAME zero padding at stride 1; the darknet downsample pads top and
    left by one, then runs stride 2 VALID.  Equal to
    ``lax.conv_general_dilated(..., preferred_element_type=int32)``.
    """
    x = q.permute(0, 2, 3, 1)                                  # NHWC view
    b, h, w, c = x.shape
    if kernel_size == 1 and not downsampling:
        ho, wo = h, w
        cols = x.reshape(b * h * w, c)
    else:
        if downsampling:
            xp, stride = F.pad(x, (0, 0, 1, 0, 1, 0)), 2
        else:
            pad = kernel_size // 2
            xp, stride = F.pad(x, (0, 0, pad, pad, pad, pad)), 1
        # (B, Ho, Wo, C, ky, kx) windows as a view, copied once into the
        # (B*Ho*Wo, ky*kx*C) im2col matrix.
        win = xp.unfold(1, kernel_size, stride).unfold(2, kernel_size, stride)
        ho, wo = win.shape[1], win.shape[2]
        cols = win.permute(0, 1, 2, 4, 5, 3).reshape(
            b * ho * wo, kernel_size * kernel_size * c)
    m = cols.shape[0]
    if m >= _MIN_ROWS:
        return torch._int_mm(cols, gemm_weight(wq).t()), (b, ho, wo)
    cols = torch.cat([cols, cols.new_zeros(_MIN_ROWS - m, cols.shape[1])])
    return torch._int_mm(cols, gemm_weight(wq).t())[:m], (b, ho, wo)


def _to_nchw(y, shape):
    """(B*Ho*Wo, Co) in NHWC order -> an NCHW view in channels_last memory."""
    b, ho, wo = shape
    return y.view(b, ho, wo, y.shape[1]).permute(0, 3, 1, 2)


def _scale_in(scale: float, dtype) -> float:
    """A scale rounded to the compute dtype (the JAX package multiplies by
    ``jnp.asarray(scale, dtype)``), as a Python float."""
    return float(torch.tensor(scale, dtype=dtype))


# ---------------------------------------------------------------------------
# Quantized apply — bf16 dataflow: quantize/dequantize around each conv
# ---------------------------------------------------------------------------

class _QuantizedApplyOps(_FoldedApplyOps):
    """int8 convs with compute-dtype tensors between ops: each eligible
    conv quantizes its input at its calibrated scale, runs the int8 GEMM,
    and dequantizes + bias + activation in its epilogue."""

    def __init__(self, params, scales, compute_dtype=torch.float32,
                 s2d_stem=False):
        super().__init__(params, compute_dtype, s2d_stem=s2d_stem)
        self.scales = scales

    def _conv_int8(self, q, p, s_in, kernel_size, downsampling, activation):
        """The int8 GEMM of ``q``, then dequantize, bias and activation."""
        y, shape = int8_conv(q, p["wq"], kernel_size, downsampling)
        f = y.float()
        f.mul_(p["sw"] * s_in).add_(p["b"])
        return _activate(_to_nchw(cast(f, self.dtype), shape), activation)

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        # The s2d stem runs two convs in one call and marks the next call
        # as activation-only (_skip_next): that comes before any look at
        # the params.
        if self._skip_next or "wq" not in self.convs[self.i]:
            return super().conv(x, filters, kernel_size,
                                downsampling=downsampling,
                                activation=activation, batch_norm=batch_norm)
        p = self.convs[self.i]
        s_in = float(self.scales["conv_in"][self.i])
        self.i += 1
        return self._conv_int8(_quantize(x, s_in), p, s_in, kernel_size,
                              downsampling, activation)


# ---------------------------------------------------------------------------
# Quantized apply — int8 dataflow: tensors between ops stay int8
# ---------------------------------------------------------------------------

def _maxpool_int8(q, pool: int):
    """Stride-1 SAME max pool of int8 NCHW ``q``, padded with -128 as the
    JAX package pads it: a running max over shifted views, rows then
    columns (exact in any memory layout; ``F.max_pool2d`` refuses int8 in
    channels_last memory on the CPU)."""
    h, w, p = q.shape[2], q.shape[3], pool // 2
    x = F.pad(q, (p, p, p, p), value=-128)
    rows = x[:, :, :h]
    for d in range(1, pool):
        rows = torch.maximum(rows, x[:, :, d:d + h])
    out = rows[:, :, :, :w]
    for d in range(1, pool):
        out = torch.maximum(out, rows[:, :, :, d:d + w])
    return out


class _QVal:
    """int8 tensor + its static per-tensor scale (a Python float)."""

    __slots__ = ("q", "scale")

    def __init__(self, q, scale: float):
        self.q = q
        self.scale = float(scale)


class _QuantizedFlowOps(_QuantizedApplyOps):
    """int8 convs AND int8 inter-op tensors.  Values are _QVal (int8 +
    static scale) in the quantized region and compute-dtype tensors at the
    float boundaries (stem, heads)."""

    def __init__(self, params, scales, compute_dtype=torch.float32,
                 s2d_stem=False):
        super().__init__(params, scales, compute_dtype, s2d_stem=s2d_stem)
        self.add_i = 0

    def _deq(self, x):
        if not isinstance(x, _QVal):
            return x
        return x.q.to(self.dtype) * _scale_in(x.scale, self.dtype)

    @staticmethod
    def _requant(f, scale: float):
        return _QVal(_quantize(f, scale), scale)

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        if self._skip_next or "wq" not in self.convs[self.i]:
            return super().conv(self._deq(x), filters, kernel_size,
                                downsampling=downsampling,
                                activation=activation, batch_norm=batch_norm)
        p = self.convs[self.i]
        i = self.i
        self.i += 1
        if isinstance(x, _QVal):
            q, s_in = x.q, x.scale
        else:
            s_in = float(self.scales["conv_in"][i])
            q = _quantize(x, s_in)
        f = self._conv_int8(q, p, s_in, kernel_size, downsampling, activation)
        return self._requant(f, float(self.scales["conv_out"][i]))

    def maxpool(self, x, pool: int):
        if not isinstance(x, _QVal):
            return super().maxpool(x, pool)
        # max commutes with the monotone, zero-point-0 dequantization.
        return _QVal(_maxpool_int8(x.q, pool), x.scale)

    def upsample(self, x):
        if not isinstance(x, _QVal):
            return super().upsample(x)
        # Nearest 2x as data movement (interpolate has no int8 kernel for
        # channels_last): each NHWC pixel repeated into a 2x2 block.
        t = x.q.permute(0, 2, 3, 1)
        b, h, w, c = t.shape
        t = t[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
        return _QVal(t.reshape(b, 2 * h, 2 * w, c).permute(0, 3, 1, 2),
                     x.scale)

    def concat(self, xs):
        if not all(isinstance(v, _QVal) for v in xs):
            return super().concat([self._deq(v) for v in xs])
        s_cat = max(v.scale for v in xs)
        parts = []
        for v in xs:
            if v.scale == s_cat:
                parts.append(v.q)
            else:
                # Rebin to the common scale; |q'| <= |q|, so no clip.  The
                # ratio is rounded to float32 first, as JAX does.
                r = float(np.float32(v.scale / s_cat))
                parts.append(torch.round(v.q.float() * r).to(torch.int8))
        return _QVal(torch.cat(parts, dim=1), s_cat)

    def add(self, a, b):
        i = self.add_i
        self.add_i += 1
        if not (isinstance(a, _QVal) and isinstance(b, _QVal)):
            return super().add(self._deq(a), self._deq(b))
        return self._requant(self._deq(a) + self._deq(b),
                             float(self.scales["add_out"][i]))


def apply_quantized(qparams, images, num_classes: int,
                    compute_dtype=torch.bfloat16,
                    csp_repeats=topology.DEFAULT_CSP_REPEATS,
                    s2d_stem: bool = True,
                    scales: Optional[Dict[str, np.ndarray]] = None,
                    dataflow: str = "int8", wrap_ops=None):
    """Inference forward over int8 params: images (B, H, W, 3) NHWC ->
    [sbbox, mbbox, lbbox] NHWC float32 raw grids, as
    ``network.apply_folded``.

    qparams: ``quantize_folded``'s params, or ``prepare_folded`` of them.
    scales: the calibration dict (numpy), read as Python floats; None reads
    ``qparams["scales"]``.  dataflow: "int8" keeps inter-op tensors int8;
    "bf16" is the per-conv scheme.  wrap_ops: as ``network.apply_folded``
    takes it.
    """
    if scales is None:
        scales = qparams["scales"]
    scales = {k: np.asarray(v) for k, v in scales.items()}
    cls = {"int8": _QuantizedFlowOps, "bf16": _QuantizedApplyOps}[dataflow]
    ops = cls(qparams, scales, compute_dtype, s2d_stem=s2d_stem)
    if wrap_ops is not None:
        ops = wrap_ops(ops)
    x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    outs = topology.yolov4(ops, x, num_classes, csp_repeats)
    return [o.permute(0, 2, 3, 1).float().contiguous() for o in outs]


def quantize(folded_params, calib_images, num_classes: int,
             compute_dtype=torch.bfloat16,
             csp_repeats=topology.DEFAULT_CSP_REPEATS):
    """One-call PTQ: calibrate activation scales, quantize weights.
    Returns (qparams, act_scales); keep act_scales to requantize after a
    weight update without calibrating again."""
    scales = calibrate(folded_params, calib_images, num_classes,
                       compute_dtype, csp_repeats)
    return quantize_folded(folded_params, scales, num_classes,
                           csp_repeats), scales
