"""YOLOv4 network in PyTorch: parameter init, BN folding, folded forward.

Counterpart of ``yolov4tpu.models.network``.  Parameters are plain
dictionaries of tensors in conv-creation order — the serial order darknet
``.weights`` files use:

    params = {"convs": [{"w", "gamma", "beta"} | {"w", "b"}, ...]}
    state  = {"bn": [{"mean", "var"} | None, ...]}

Kernels are OIHW (PyTorch's layout; the JAX package keeps HWIO), so
``params_from_jax`` transposes.  The public forward takes NHWC images and
returns NHWC raw grids like the JAX package; inside, activations are NCHW
tensors in ``channels_last`` memory format, which is the same bytes.

Layer semantics (reference custom_layers.py:5-31):
  - downsampling convs: top/left zero pad + stride-2 VALID conv;
  - BatchNorm with Keras eps=1e-3 and momentum 0.99: batch statistics in
    training (``apply(train=True)``), folded into conv weight + bias for
    inference (``fold_bn`` + ``apply_folded``);
  - mish via the single-exp identity, leaky-relu alpha=0.1.

YOLOv4-P6 (``arch="yolov4-p6"``, ``topology.yolov4_p6``) adds a list of
the BN + mish norms that follow its concats:

    params = {"convs": [{"w", "gamma", "beta"} | {"w", "b"} | {"w"}, ...],
              "norms": [{"gamma", "beta"}, ...]}
    state  = {"bn": [{"mean", "var"} | None, ...],
              "norms": [{"mean", "var"}, ...]}

where {"w"} is a plain conv (no BN, no bias, no activation).  Every half
of a norm's concat is the output of one conv, so ``fold_bn`` folds the
norm into those convs: a plain conv takes its half's scale into its
weight and its shift as its bias, and then ends in mish; a conv that
already ends in BN + mish keeps its half as a second stage of its
epilogue, ``mish(s * mish(y + b) + t)`` (``ConvSpec.norm``).

The folded forward (``apply_folded``) ends every conv in
``ops.epilogue.conv_epilogue``: bias add and activation in one
hand-written CUDA pass on the card (``csrc/conv_epilogue.cu``), bit for
bit the eager ``_activate(y + _bias(b))`` that it runs on the CPU and
that ``apply`` (BN inference) keeps.  ``_mish``, ``_activate`` and
``_bias`` live in ``ops.epilogue`` beside the kernel's wrapper.

The training forward (``apply(train=True)``) ends every BN conv in
``ops.bn_act.bn_act``: the batch statistics, BN and the activation as one
autograd op whose forward and backward are hand-written CUDA on the card
(``csrc/bn_act.cu``), and the eager chain ``bn_act_reference`` elsewhere.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.bn_act import BN_EPS, batch_norm_train, bn_act
from ..ops.epilogue import (_activate, _bias, _mish,  # noqa: F401
                            conv_epilogue, conv_epilogue_merge)
from . import topology

GRAPHS = {"yolov4": topology.yolov4, "yolov4-p6": topology.yolov4_p6}


# ---------------------------------------------------------------------------
# Conv layer spec (static metadata recorded at init, reused by the importer)
# ---------------------------------------------------------------------------

class ConvSpec:
    """Static description of one conv layer, in darknet serial order.

    ``norm``: None, or (norm index, channel offset) of the concat norm
    that takes this conv's output as its channels [offset, offset +
    filters) (P6): folded into the weight of a plain conv, a second
    epilogue stage of a conv that ends in BN + activation (``merge``)."""

    __slots__ = ("index", "in_ch", "filters", "kernel_size", "downsampling",
                 "activation", "batch_norm", "norm")

    def __init__(self, index, in_ch, filters, kernel_size, downsampling,
                 activation, batch_norm, norm=None):
        self.index = index
        self.in_ch = in_ch
        self.filters = filters
        self.kernel_size = kernel_size
        self.downsampling = downsampling
        self.activation = activation
        self.batch_norm = batch_norm
        self.norm = norm

    @property
    def merge(self) -> bool:
        """Whether the fold gives this conv a second epilogue stage."""
        return self.norm is not None and self.batch_norm

    def __repr__(self):
        norm = f" norm{self.norm}" if self.norm is not None else ""
        return (f"ConvSpec({self.index}: {self.in_ch}->{self.filters} "
                f"k{self.kernel_size}{' s2' if self.downsampling else ''} "
                f"{self.activation or 'linear'}{' bn' if self.batch_norm else ''}"
                f"{norm})")


# ---------------------------------------------------------------------------
# Init: shape-trace the topology, creating params in call order
# ---------------------------------------------------------------------------

class _ShapeVal:
    """A tensor's shape in the trace; ``parts``: the (conv index or None,
    channels) runs its channels come from, in order."""

    __slots__ = ("h", "w", "c", "parts")

    def __init__(self, h, w, c, src=None):
        self.h, self.w, self.c = h, w, c
        self.parts = ((src, c),)


class _InitOps:
    """Ops backend that traces shapes and materialises parameters.

    Draws the same numpy ``default_rng`` stream, in the same HWIO shape, as
    the JAX package's init, so ``init(seed)`` gives the same values there and
    here (transposed to OIHW).
    """

    def __init__(self, rng: Optional[np.random.Generator]):
        self.rng = rng  # None: record the specs only
        self.specs: List[ConvSpec] = []
        self.params: List[Dict[str, torch.Tensor]] = []
        self.state: List[Optional[Dict[str, torch.Tensor]]] = []
        self.norms: List[Dict[str, torch.Tensor]] = []
        self.norm_state: List[Dict[str, torch.Tensor]] = []

    def conv(self, x: _ShapeVal, filters: int, kernel_size: int,
             downsampling: bool = False, activation: str = "leaky",
             batch_norm: bool = True, bias: bool = True) -> _ShapeVal:
        idx = len(self.specs)
        self.specs.append(ConvSpec(idx, x.c, filters, kernel_size,
                                   downsampling, activation, batch_norm))
        if self.rng is not None:
            self._materialise(x.c, filters, kernel_size, batch_norm, bias)
        if downsampling:
            return _ShapeVal(x.h // 2, x.w // 2, filters, idx)
        return _ShapeVal(x.h, x.w, filters, idx)

    def plain_conv(self, x: _ShapeVal, filters: int) -> _ShapeVal:
        return self.conv(x, filters, 1, activation=None, batch_norm=False,
                         bias=False)

    def norm_act(self, x: _ShapeVal) -> _ShapeVal:
        """BN + mish over ``x``, a concat of conv outputs: each conv's
        spec learns its channels of this norm."""
        site, offset = len(self.norms), 0
        for src, c in x.parts:
            if src is None or self.specs[src].norm is not None:
                raise ValueError("a norm's concat must be of conv outputs, "
                                 "each read by this norm alone")
            self.specs[src].norm = (site, offset)
            offset += c
        self.norms.append({"gamma": torch.ones(x.c),
                           "beta": torch.zeros(x.c)})
        self.norm_state.append({"mean": torch.zeros(x.c),
                                "var": torch.ones(x.c)})
        return _ShapeVal(x.h, x.w, x.c)

    def _materialise(self, in_ch, filters, kernel_size, batch_norm, bias):
        w = self.rng.normal(0.0, 0.01,
                            (kernel_size, kernel_size, in_ch, filters)
                            ).astype(np.float32)
        p = {"w": torch.from_numpy(np.ascontiguousarray(w.transpose(3, 2, 0, 1)))}
        if batch_norm:
            p["gamma"] = torch.ones(filters)
            p["beta"] = torch.zeros(filters)
            self.state.append({"mean": torch.zeros(filters),
                               "var": torch.ones(filters)})
        else:
            if bias:
                p["b"] = torch.zeros(filters)
            self.state.append(None)
        self.params.append(p)

    def upsample(self, x: _ShapeVal) -> _ShapeVal:
        return _ShapeVal(x.h * 2, x.w * 2, x.c)

    def maxpool(self, x: _ShapeVal, pool: int) -> _ShapeVal:
        return x  # stride-1 SAME pool: shape-preserving

    def concat(self, xs: Sequence[_ShapeVal]) -> _ShapeVal:
        out = _ShapeVal(xs[0].h, xs[0].w, sum(v.c for v in xs))
        out.parts = tuple(p for v in xs for p in v.parts)
        return out

    def add(self, a: _ShapeVal, b: _ShapeVal) -> _ShapeVal:
        return a


def init(num_classes: int, img_size: int = 416, seed: int = 0,
         csp_repeats=topology.DEFAULT_CSP_REPEATS, arch: str = "yolov4"):
    """Create (params, state, conv_specs) for the full network of
    ``arch``; P6's carry its concat norms under "norms"."""
    ops = _InitOps(np.random.default_rng(seed))
    GRAPHS[arch](ops, _ShapeVal(img_size, img_size, 3), num_classes,
                 tuple(csp_repeats))
    params, state = {"convs": ops.params}, {"bn": ops.state}
    if ops.norms:
        params["norms"], state["norms"] = ops.norms, ops.norm_state
    return params, state, ops.specs


@functools.lru_cache(maxsize=8)
def conv_specs(num_classes: int,
               csp_repeats=topology.DEFAULT_CSP_REPEATS,
               arch: str = "yolov4") -> Tuple[ConvSpec, ...]:
    """Conv-layer inventory in darknet serial order (shape trace only)."""
    ops = _InitOps(None)
    GRAPHS[arch](ops, _ShapeVal(416, 416, 3), num_classes,
                 tuple(csp_repeats))
    return tuple(ops.specs)


def params_from_jax(params, state):
    """The JAX package's (params, state) pytrees, as numpy arrays, -> the
    port's dictionaries of CPU float32 tensors (kernels HWIO -> OIHW)."""
    def tensors(d):
        return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in d.items()}

    convs = []
    for p in params["convs"]:
        q = tensors(p)
        q["w"] = q["w"].permute(3, 2, 0, 1).contiguous()
        convs.append(q)
    bn = [None if s is None else tensors(s) for s in state["bn"]]
    return {"convs": convs}, {"bn": bn}


def params_to_jax(params, state):
    """The inverse of ``params_from_jax``: the port's (params, state), on
    any device, -> the JAX package's pytrees of numpy float32 arrays
    (kernels OIHW -> HWIO; convs without BN keep their None state).  The
    arrays are copies: later steps do not change them."""
    def arrays(d):
        out = {}
        for k, v in d.items():
            v = v.detach().to(torch.float32)
            if k == "w":
                v = v.permute(2, 3, 1, 0)
            out[k] = v.clone(memory_format=torch.contiguous_format).cpu().numpy()
        return out

    convs = [arrays(p) for p in params["convs"]]
    bn = [None if s is None else arrays(s) for s in state["bn"]]
    return {"convs": convs}, {"bn": bn}


# ---------------------------------------------------------------------------
# BN folding and the folded (inference) forward
# ---------------------------------------------------------------------------

class _NCHWOps:
    """The shape ops of the topology on NCHW activations, shared by the
    training and the folded backends."""

    def upsample(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")

    def maxpool(self, x, pool: int):
        # Stride-1 SAME max pool; max_pool2d pads with -inf.
        return F.max_pool2d(x, pool, stride=1, padding=pool // 2)

    def concat(self, xs):
        return torch.cat(xs, dim=1)

    def add(self, a, b):
        return a + b


class _ApplyOps(_NCHWOps):
    """Ops backend over (params, state) with BatchNorm, on NCHW activations
    (counterpart of the JAX package's ``_ApplyOps``)."""

    def __init__(self, params, state, train: bool,
                 compute_dtype=torch.float32, stats_gradient: bool = True,
                 sample_mask=None, pallas_wgrad: bool = False):
        self.convs = params["convs"]
        self.bn = state["bn"]
        self.norms = params.get("norms", ())
        self.norm_state = state.get("norms", ())
        self.j = 0
        self.new_norms: List[Dict[str, torch.Tensor]] = []
        self.train = train
        self.dtype = compute_dtype
        self.stats_gradient = stats_gradient
        # (B,) 0/1 validity mask for padded batches: BN batch statistics
        # count the valid samples only.
        self.sample_mask = sample_mask
        self.pallas_wgrad = pallas_wgrad
        self.i = 0
        self.new_bn: List[Optional[Dict[str, torch.Tensor]]] = []

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        p = self.convs[self.i]
        bn = self.bn[self.i]
        self.i += 1
        w = p["w"].to(self.dtype)
        xc = x.to(self.dtype)
        if downsampling:
            y = F.conv2d(F.pad(xc, (1, 0, 1, 0)), w, stride=2)
        elif self.pallas_wgrad and self.train and kernel_size == 3:
            from ..ops.wgrad_cuda import conv3x3_s1
            y = conv3x3_s1(xc, w)
        else:
            y = F.conv2d(xc, w, padding=kernel_size // 2)

        if not batch_norm:
            self.new_bn.append(None)
            if "b" not in p:       # plain conv
                return y
            return _activate(y + _bias(p["b"], self.dtype), activation)
        if self.train:
            out, mean, var = bn_act(y, p["gamma"], p["beta"], bn["mean"],
                                    bn["var"], activation, self.sample_mask,
                                    self.stats_gradient)
            self.new_bn.append({"mean": mean, "var": var})
            return out
        y, new = self._normalise(y, p["gamma"], p["beta"], bn)
        self.new_bn.append(new)
        return _activate(y, activation)

    def plain_conv(self, x, filters):
        return self.conv(x, filters, 1, activation=None, batch_norm=False)

    def norm_act(self, x):
        """BN (this pass's statistics in training) + mish over a concat."""
        p, bn = self.norms[self.j], self.norm_state[self.j]
        self.j += 1
        y, new = self._normalise(x.to(self.dtype), p["gamma"], p["beta"], bn)
        self.new_norms.append(new)
        return _activate(y, "mish")

    def _normalise(self, y, gamma, beta, bn):
        """(BN of ``y``, the BN state after it)."""
        if self.train:
            z, mean, var = batch_norm_train(
                y, gamma, beta, bn["mean"], bn["var"], self.sample_mask,
                self.stats_gradient)
            return z, {"mean": mean, "var": var}
        mean, var = bn["mean"], bn["var"]
        inv = torch.rsqrt(var + BN_EPS)
        scale = (gamma * inv).to(self.dtype)
        shift = (beta - mean * gamma * inv).to(self.dtype)
        return y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1), bn



def apply(params, state, images, num_classes: int, train: bool = False,
          compute_dtype=torch.float32,
          csp_repeats=topology.DEFAULT_CSP_REPEATS,
          bn_stats_gradient: bool = True, sample_mask=None,
          pallas_wgrad: bool = False, arch: str = "yolov4"):
    """Forward with BatchNorm: images (B, H, W, 3) NHWC ->
    ([sbbox, mbbox, lbbox] NHWC float32 raw grids, new_state).

    With ``train=True`` BN normalises by the batch statistics and
    ``new_state`` carries the updated moving statistics (detached);
    ``bn_stats_gradient=False`` treats the batch statistics as constants in
    the backward pass; ``sample_mask`` (B,) 0/1 leaves padded samples out of
    them; ``pallas_wgrad`` routes every 3x3 stride-1 conv through
    ``ops.wgrad_cuda.conv3x3_s1``.  Counterpart of the JAX package's
    ``network.apply``.  ``arch`` "yolov4-p6" runs P6 (its params with
    "norms"; four grids).
    """
    ops = _ApplyOps(params, state, train, compute_dtype,
                    stats_gradient=bn_stats_gradient,
                    sample_mask=sample_mask, pallas_wgrad=pallas_wgrad)
    x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    outs = GRAPHS[arch](ops, x, num_classes, tuple(csp_repeats))
    outs = [o.permute(0, 2, 3, 1).float().contiguous() for o in outs]
    if not train:
        return outs, state
    new_state = {"bn": ops.new_bn}
    if "norms" in state:
        new_state["norms"] = ops.new_norms
    return outs, new_state


def _scale_shift(gamma, beta, bn):
    scale = gamma * (1.0 / torch.sqrt(bn["var"] + BN_EPS))
    return scale, beta - bn["mean"] * scale


def fold_bn(params, state, specs=None):
    """Fold BN into conv weight + bias:
    w' = w*g/sqrt(v+eps), b' = beta - m*g/sqrt(v+eps).

    With concat norms (P6; ``specs`` its ``conv_specs``): a plain conv
    takes its half of the norm the same way (w' = w*s, b' = t) and ends in
    mish; a conv that ends in BN + mish keeps its half as the epilogue's
    second stage, keys "s" and "t": mish(s * mish(y + b) + t)."""
    norms = params.get("norms")
    if norms and specs is None:
        raise ValueError("folding concat norms needs the conv_specs")
    folded = []
    for i, (p, bn) in enumerate(zip(params["convs"], state["bn"])):
        if bn is None:
            q = {"w": p["w"], "b": p.get("b")}
        else:
            scale, shift = _scale_shift(p["gamma"], p["beta"], bn)
            q = {"w": p["w"] * scale[:, None, None, None], "b": shift}
        norm = specs[i].norm if norms else None
        if norm is not None:
            site, off = norm
            s, t = (v[off:off + p["w"].shape[0]] for v in _scale_shift(
                norms[site]["gamma"], norms[site]["beta"],
                state["norms"][site]))
            if bn is None:      # a plain conv
                q = {"w": q["w"] * s[:, None, None, None], "b": t}
            else:
                q["s"], q["t"] = s, t
        if q["b"] is None:
            raise ValueError(f"plain conv {i} feeds no norm: nothing to "
                             f"fold it into")
        folded.append(q)
    return {"convs": folded}


def _s2d_stem_kernels(w1, b1, w2):
    """Reindex the two stem convs into space-to-depth (2x2 block) space.

    conv0 (3->32, 3x3 s1 SAME) and conv1 (32->64, 3x3 s2, top/left pad)
    become conv1' (3x3 over the 12 s2d channels -> 4 phases x 32) and conv2'
    (2x2 over those 128 -> 64, pad top/left), both stride 1 on the half-size
    grid.  An exact reparametrisation: taps outside the original padding
    land on zero kernel slots.  An output row r = 2i + p (block i, phase p)
    taps input rows r + d - 1 for kernel row d, i.e. block row i + D - 1,
    phase a, with D = (p + d + 1) // 2, a = (p + d + 1) % 2 (conv2' has
    output phase 0).  s2d channel order: (a_row * 2 + a_col) * C + c.

    Kernels are OIHW here: w1 (32, 3, 3, 3), w2 (64, 32, 3, 3).
    """
    c1, cin = w1.shape[0], w1.shape[1]
    c2 = w2.shape[0]
    w1p = w1.new_zeros((4 * c1, 4 * cin, 3, 3))
    for pr in range(2):
        for pc in range(2):
            for di in range(3):
                for dj in range(3):
                    Dr, ar = (pr + di + 1) // 2, (pr + di + 1) % 2
                    Dc, ac = (pc + dj + 1) // 2, (pc + dj + 1) % 2
                    ci = (ar * 2 + ac) * cin
                    co = (pr * 2 + pc) * c1
                    w1p[co:co + c1, ci:ci + cin, Dr, Dc] = w1[:, :, di, dj]
    b1p = b1.repeat(4)
    w2p = w2.new_zeros((c2, 4 * c1, 2, 2))
    for di in range(3):
        for dj in range(3):
            Dr, ar = (di + 1) // 2, (di + 1) % 2
            Dc, ac = (dj + 1) // 2, (dj + 1) % 2
            ci = (ar * 2 + ac) * c1
            w2p[:, ci:ci + c1, Dr, Dc] = w2[:, :, di, dj]
    return w1p, b1p, w2p


def prepare_folded(folded, device, compute_dtype=torch.float32):
    """Folded params on ``device`` in ``compute_dtype`` with channels_last
    kernels, plus the s2d stem kernels (key ``"s2d"``), built once so the
    forward does not rebuild them per call.  Casting once here equals the
    per-conv cast of the JAX forward: both round the same f32 values.

    A conv of int8 params (``quantize.quantize_folded``) keeps ``wq`` int8,
    laid out once as its GEMM's (Co, kh*kw*Ci) matrix, and its ``sw`` and
    ``b`` in float32; their calibration scales (numpy) are kept as they
    are."""
    from .quantize import gemm_weight

    def prepare(p):
        if "wq" in p:
            return {"wq": gemm_weight(p["wq"]).to(device),
                    "sw": p["sw"].to(device, torch.float32),
                    "b": p["b"].to(device, torch.float32)}
        out = {"w": p["w"].to(device, compute_dtype).contiguous(
                   memory_format=torch.channels_last)}
        out.update({k: p[k].to(device, compute_dtype)
                    for k in ("b", "s", "t") if k in p})
        return out

    convs = [prepare(p) for p in folded["convs"]]
    w1p, b1p, w2p = _s2d_stem_kernels(folded["convs"][0]["w"],
                                      folded["convs"][0]["b"],
                                      folded["convs"][1]["w"])
    w1p, w2p = (t.to(device, compute_dtype).contiguous(
        memory_format=torch.channels_last) for t in (w1p, w2p))
    out = {"convs": convs, "s2d": (w1p, b1p.to(device, compute_dtype), w2p)}
    if "scales" in folded:
        out["scales"] = folded["scales"]
    return out


def cast(x, dtype):
    """``x.to(dtype)``, left out where it changes nothing, so that an
    exported program (``serving``) holds no casts that do nothing."""
    return x if x.dtype == dtype else x.to(dtype)


class _FoldedApplyOps(_NCHWOps):
    """Ops backend over folded params (every conv is w+b, no BN) on NCHW
    activations.  Every conv ends in ``_epilogue``, the custom op
    ``conv_epilogue``, or, with a second stage ("s", "t": P6), in
    ``conv_epilogue_merge``.  A plain conv's norm is folded into it, so it
    ends in mish, and ``norm_act`` has nothing left to do."""

    def __init__(self, params, compute_dtype=torch.float32, s2d_stem=False):
        self.params = params
        self.convs = params["convs"]
        self.dtype = compute_dtype
        self.i = 0
        self.s2d_stem = s2d_stem
        self._skip_next = False

    def _epilogue(self, y, b, activation):
        """act(y + b) for a conv output ``y`` in the compute dtype."""
        return conv_epilogue(y, cast(b, self.dtype), activation or "linear")

    def _stem_pair_s2d(self, x, activation):
        """Both stem convs in block space (see _s2d_stem_kernels)."""
        if "s2d" in self.params:
            w1p, b1p, w2p = self.params["s2d"]
        else:
            w1p, b1p, w2p = _s2d_stem_kernels(
                self.convs[0]["w"], self.convs[0]["b"], self.convs[1]["w"])
        b, c, h, w = x.shape
        xb = x.permute(0, 2, 3, 1).reshape(b, h // 2, 2, w // 2, 2, c)
        xb = xb.permute(0, 1, 3, 2, 4, 5).reshape(b, h // 2, w // 2, 4 * c)
        xb = cast(xb.permute(0, 3, 1, 2), self.dtype)
        y = F.conv2d(xb, cast(w1p, self.dtype), padding=1)
        y = self._epilogue(y, b1p, activation)
        # conv1's raw output: its bias and activation are applied by the
        # (skipped) second conv() call, so any activation combination
        # stays exact.
        return F.conv2d(F.pad(y, (1, 0, 1, 0)), cast(w2p, self.dtype))

    def conv(self, x, filters, kernel_size, downsampling=False,
             activation="leaky", batch_norm=True):
        if (self.s2d_stem and self.i == 0 and kernel_size == 3
                and not downsampling and x.shape[1] == 3
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
            # Runs conv 0 (3->32 s1) AND conv 1 (32->64 s2 downsample): the
            # next conv() call only applies conv 1's activation.
            self.i = 2
            self._skip_next = True
            return self._stem_pair_s2d(x, activation)
        if self._skip_next:
            self._skip_next = False
            if not (downsampling and kernel_size == 3):
                raise ValueError("s2d stem expects the darknet downsample "
                                 "conv right after the stem conv")
            return self._epilogue(x, self.convs[1]["b"], activation)
        p = self.convs[self.i]
        self.i += 1
        x, w = cast(x, self.dtype), cast(p["w"], self.dtype)
        if downsampling:
            # Darknet-compatible top/left zero pad, then stride-2 VALID.
            y = F.conv2d(F.pad(x, (1, 0, 1, 0)), w, stride=2)
        else:
            y = F.conv2d(x, w, padding=kernel_size // 2)
        if "s" in p:
            return conv_epilogue_merge(y, cast(p["b"], self.dtype),
                                       cast(p["s"], self.dtype),
                                       cast(p["t"], self.dtype))
        return self._epilogue(y, p["b"], activation)

    def plain_conv(self, x, filters):
        return self.conv(x, filters, 1, activation="mish")

    def norm_act(self, x):
        return x



def apply_folded(folded_params, images, num_classes: int,
                 compute_dtype=torch.float32,
                 csp_repeats=topology.DEFAULT_CSP_REPEATS,
                 s2d_stem: bool = True, wrap_ops=None, arch: str = "yolov4"):
    """Inference forward over BN-folded params.

    images (B, H, W, 3) NHWC -> [sbbox, mbbox, lbbox] raw grids, NHWC
    float32 (B, H/s, W/s, 3*(5+C)).  Convs run in ``compute_dtype``, bias
    added in it, outputs cast back to float32 (as the JAX package does).
    ``wrap_ops``: None, or a callable that takes the ops backend and
    returns the op set the topology runs on (``parallel.spatial``).
    ``arch`` "yolov4-p6": P6's four grids, over ``fold_bn``'s params with
    their second stages.
    """
    ops = _FoldedApplyOps(folded_params, compute_dtype, s2d_stem=s2d_stem)
    if wrap_ops is not None:
        ops = wrap_ops(ops)
    x = images.permute(0, 3, 1, 2)  # NCHW view, channels_last memory
    outs = GRAPHS[arch](ops, x, num_classes, tuple(csp_repeats))
    return [o.permute(0, 2, 3, 1).float().contiguous() for o in outs]
