"""YOLOv4-P6 of Scaled-YOLOv4 (Wang, Bochkovskiy and Liao, CVPR 2021,
arXiv:2011.08036) in plain float32 PyTorch, from its published description:
ScaledYOLOv4's yolov4-large branch, ``models/yolov4-p6.yaml`` (the tables
``BACKBONE`` and ``HEAD`` below, row for row) and the blocks of
``models/common.py`` (``Conv``, ``Bottleneck``, ``BottleneckCSP``,
``BottleneckCSP2``, ``SPPCSP``), the anchors of the yaml and the decode of
``models/yolo.py``'s ``Detect``.  It imports nothing of the program under
test.

- Conv(c2, k, s): conv k x k, stride s, pad k // 2, no bias -> BN (eps
  1e-3, running statistics) -> mish.  Every BN is applied as it stands,
  unfolded: the program folds them, and this checks its fold.
- BottleneckCSP, BottleneckCSP2 and SPPCSP end in a BN + mish over the
  concat of two halves, each the output of one conv; a ``plain`` conv is
  1 x 1 with no BN, no bias and no activation.
- Detect: a 1 x 1 conv with bias to 4 * (5 + C) channels a scale, laid
  out (anchor, 5 + C); every channel through a sigmoid, xy = (2 s - 0.5 +
  grid) * stride, wh = (2 s)^2 * anchor, score = obj * cls.

Weights are the benchmark's dictionaries: ``{"convs": [{"w", "gamma",
"beta"} | {"w", "b"} | {"w"}], "norms": [{"gamma", "beta"}]}`` and
``{"bn": [{"mean", "var"} | None], "norms": [{"mean", "var"}]}``, kernels
OIHW; the convs in the order the forward calls them, the concat norms in
the order it reaches them (``make``).

Departures from the source: the source letterboxes an image to 1280 with
padding to a stride multiple; here the images are square already, at a
side that is a multiple of 64.  The thresholds (score 0.4, IoU 0.5) are
the source's ``detect.py`` defaults; its NMS (torchvision's batched NMS,
class-agnostic offsets, a 300-box cap) is replaced by the benchmark's
exact per-class greedy NMS (``nms``) with the program's caps.  ``depth``
may lower the Bottleneck counts (the tests' small models).

Float32 convolutions run with TF32 off.  ``quant`` rounds every tensor a
layer reads or makes (input, kernel, conv output, normalised output, the
activation, a residual sum, the head's bias and sum) to a lower precision
(``lowp``), as a network held in that precision stores it; with
``mish_steps`` also each step of mish, as eager bfloat16 arithmetic
rounds them (the bfloat16 yardstick).  The float8 control leaves mish's
temporaries in float32: one per-tensor float8 scale cannot hold e^x over
[-20, 20], and rounding it flushes all but the largest to zero.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

BN_EPS = 1e-3
NUM_CLASSES = 80
ANCHORS = (((13, 17), (31, 25), (24, 51), (61, 45)),
           ((61, 45), (48, 102), (119, 96), (97, 189)),
           ((97, 189), (217, 184), (171, 384), (324, 451)),
           ((324, 451), (545, 357), (616, 618), (1024, 1024)))
STRIDES = (8, 16, 32, 64)
SCORE_T, IOU_T = 0.4, 0.5

# (from, n, module, args): yolov4-p6.yaml.  "csp" BottleneckCSP, "csp2"
# BottleneckCSP2, "sppcsp" SPPCSP, "up" nearest x2, "cat" concat.
BACKBONE = (
    (-1, 1, "conv", (32, 3, 1)),
    (-1, 1, "conv", (64, 3, 2)),
    (-1, 1, "csp", (64,)),
    (-1, 1, "conv", (128, 3, 2)),
    (-1, 3, "csp", (128,)),
    (-1, 1, "conv", (256, 3, 2)),
    (-1, 15, "csp", (256,)),
    (-1, 1, "conv", (512, 3, 2)),
    (-1, 15, "csp", (512,)),
    (-1, 1, "conv", (1024, 3, 2)),
    (-1, 7, "csp", (1024,)),
    (-1, 1, "conv", (1024, 3, 2)),
    (-1, 7, "csp", (1024,)),
)
HEAD = (
    (-1, 1, "sppcsp", (512,)),
    (-1, 1, "conv", (512, 1, 1)),
    (-1, 1, "up", ()),
    (10, 1, "conv", (512, 1, 1)),
    ((16, 15), 1, "cat", ()),
    (-1, 3, "csp2", (512,)),
    (-1, 1, "conv", (256, 1, 1)),
    (-1, 1, "up", ()),
    (8, 1, "conv", (256, 1, 1)),
    ((21, 20), 1, "cat", ()),
    (-1, 3, "csp2", (256,)),
    (-1, 1, "conv", (128, 1, 1)),
    (-1, 1, "up", ()),
    (6, 1, "conv", (128, 1, 1)),
    ((26, 25), 1, "cat", ()),
    (-1, 3, "csp2", (128,)),
    (-1, 1, "conv", (256, 3, 1)),
    (28, 1, "conv", (256, 3, 2)),
    ((30, 23), 1, "cat", ()),
    (-1, 3, "csp2", (256,)),
    (-1, 1, "conv", (512, 3, 1)),
    (32, 1, "conv", (512, 3, 2)),
    ((34, 18), 1, "cat", ()),
    (-1, 3, "csp2", (512,)),
    (-1, 1, "conv", (1024, 3, 1)),
    (36, 1, "conv", (512, 3, 2)),
    ((38, 13), 1, "cat", ()),
    (-1, 3, "csp2", (512,)),
    (-1, 1, "conv", (1024, 3, 1)),
)
OUTPUTS = (29, 33, 37, 41)  # the Detect's inputs
DEPTH = tuple(n for _, n, m, _ in BACKBONE if m == "csp") + (3,)


@contextlib.contextmanager
def strict_fp32():
    """TF32 off for matmuls and cuDNN convolutions inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _same(t):
    return t


def mish(x, q=None):
    """x * tanh(softplus(x)); with ``q``, as a network held in a lower
    precision computes it, through tanh(softplus(x)) = n / (n + 2), n = u^2
    + 2u, u = e^x (x itself above 20), one rounding an operation."""
    if q is None:
        return x * torch.tanh(F.softplus(x))
    u = q(torch.exp(torch.clamp(x, max=20.0)))
    n = q(q(u * u) + q(2.0 * u))
    return torch.where(x > 20.0, x, q(x * q(n / q(n + 2.0))))


class _Walk:
    """Runs the tables over an op set that knows ``conv(x, c2, k, s)``,
    ``plain(x, c2)``, ``norm(x)`` (BN + mish), ``head(x, c2)``, ``add``,
    ``cat``, ``maxpool`` and ``up``; the Bottleneck counts from
    ``depth``."""

    def __init__(self, ops, depth):
        self.ops, self.depth = ops, tuple(depth)

    def bottleneck(self, x, c, shortcut):
        o = self.ops
        y = o.conv(o.conv(x, c, 1, 1), c, 3, 1)
        return o.add(x, y) if shortcut else y

    def module(self, kind, x, n, args):
        o = self.ops
        if kind == "conv":
            return o.conv(x, *args)
        if kind == "up":
            return o.up(x)
        if kind == "cat":
            return o.cat(x)
        c2 = args[0]
        if kind == "csp":
            c_ = c2 // 2
            y = o.conv(x, c_, 1, 1)
            for _ in range(n):
                y = self.bottleneck(y, c_, True)
            y1 = o.plain(y, c_)
            y2 = o.plain(x, c_)
        elif kind == "csp2":
            x1 = o.conv(x, c2, 1, 1)
            y1 = x1
            for _ in range(n):
                y1 = self.bottleneck(y1, c2, False)
            y2 = o.plain(x1, c2)
        elif kind == "sppcsp":
            x1 = o.conv(o.conv(o.conv(x, c2, 1, 1), c2, 3, 1), c2, 1, 1)
            y = o.cat([x1] + [o.maxpool(x1, k) for k in (5, 9, 13)])
            y1 = o.conv(o.conv(y, c2, 1, 1), c2, 3, 1)
            y2 = o.plain(x, c2)
        else:
            raise ValueError(kind)
        return o.conv(o.norm(o.cat([y1, y2])), c2, 1, 1)

    def run(self, x, num_classes):
        outs = []
        stages = iter(self.depth[:6])
        for f, n, kind, args in BACKBONE + HEAD:
            if kind == "csp":
                n = next(stages)
            elif kind == "csp2":
                n = self.depth[6]
            src = ([outs[i] for i in f] if isinstance(f, tuple)
                   else x if f == -1 else outs[f])
            x = self.module(kind, src, n, args)
            outs.append(x)
        return [self.ops.head(outs[i], 4 * (5 + num_classes))
                for i in OUTPUTS]


class _Forward:
    """The float32 forward over (params, state), BN unfolded."""

    def __init__(self, params, state, quant=None, mish_steps=True):
        self.convs, self.bn = params["convs"], state["bn"]
        self.norms, self.norm_bn = params["norms"], state["norms"]
        self.i = self.j = 0
        self.q = quant or _same
        self.quant = quant if mish_steps else None

    def _bn(self, y, p, bn):
        s = p["gamma"] / torch.sqrt(bn["var"] + BN_EPS)
        return self.q((y - bn["mean"].view(1, -1, 1, 1)) * s.view(1, -1, 1, 1)
                      + p["beta"].view(1, -1, 1, 1))

    def _conv(self, x, k, s):
        p = self.convs[self.i]
        self.i += 1
        q = self.q
        return q(F.conv2d(q(x), q(p["w"]), stride=s, padding=k // 2)), p

    def conv(self, x, c2, k, s):
        bn = self.bn[self.i]
        y, p = self._conv(x, k, s)
        return self.q(mish(self._bn(y, p, bn), self.quant))

    def plain(self, x, c2):
        return self._conv(x, 1, 1)[0]

    def norm(self, x):
        p, bn = self.norms[self.j], self.norm_bn[self.j]
        self.j += 1
        return self.q(mish(self._bn(x, p, bn), self.quant))

    def head(self, x, c2):
        y, p = self._conv(x, 1, 1)
        return self.q(y + self.q(p["b"]).view(1, -1, 1, 1))

    def add(self, a, b):
        return self.q(a + b)

    def cat(self, xs):
        return torch.cat(xs, 1)

    def maxpool(self, x, k):
        return F.max_pool2d(x, k, stride=1, padding=k // 2)

    def up(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


def forward(params, state, images, num_classes: int = NUM_CLASSES,
            quant=None, depth=DEPTH, mish_steps=True):
    """NHWC float images in [0, 1] -> the four raw grids (B, g, g, 4 * (5 +
    C)) NHWC, strides 8 to 64."""
    with strict_fp32(), torch.no_grad():
        x = images.float().permute(0, 3, 1, 2).contiguous()
        outs = _Walk(_Forward(params, state, quant, mish_steps), depth).run(
            x, num_classes)
        return [o.permute(0, 2, 3, 1).contiguous() for o in outs]


def decode(raws, num_classes: int, side: int, anchors=ANCHORS,
           strides=STRIDES):
    """The Detect's decode of every anchor: boxes (B, N, 4) corners in [0,
    1] coordinates (not clipped) and scores (B, N, C), anchors in (row,
    column, anchor) order."""
    boxes, scores = [], []
    for i, raw in enumerate(raws):
        b, gh, gw = raw.shape[:3]
        na = len(anchors[i])
        y = torch.sigmoid(raw.float().reshape(b, gh, gw, na, 5 + num_classes))
        rows, cols = torch.meshgrid(
            torch.arange(gh, device=raw.device, dtype=torch.float32),
            torch.arange(gw, device=raw.device, dtype=torch.float32),
            indexing="ij")
        grid = torch.stack([cols, rows], -1)[:, :, None, :]
        a = torch.tensor(anchors[i], dtype=torch.float32, device=raw.device)
        xy = (y[..., :2] * 2.0 - 0.5 + grid) * strides[i]
        wh = (y[..., 2:4] * 2.0) ** 2 * a
        boxes.append(torch.cat([xy - wh / 2, xy + wh / 2], -1)
                     .reshape(b, -1, 4) / side)
        scores.append((y[..., 4:5] * y[..., 5:]).reshape(b, -1, num_classes))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


class _Trace:
    """The op set of the shape trace: (h, w, c) values; records each conv
    as a dict and each norm's channels."""

    def __init__(self):
        self.convs, self.norms = [], []

    def _add(self, x, c2, k, s, kind):
        h, w, c = x[:3]
        ho, wo = (h + 2 * (k // 2) - k) // s + 1, (w + 2 * (k // 2) - k) // s + 1
        self.convs.append({"ci": c, "co": c2, "k": k, "s": s, "h": ho,
                           "w": wo, "kind": kind})
        return (ho, wo, c2, len(self.convs) - 1)

    def conv(self, x, c2, k, s):
        return self._add(x, c2, k, s, "conv")

    def plain(self, x, c2):
        return self._add(x, c2, 1, 1, "plain")

    def head(self, x, c2):
        return self._add(x, c2, 1, 1, "head")

    def norm(self, x):
        self.norms.append({"c": x[2], "h": x[0], "w": x[1],
                           "parts": x[3]})
        return x[:3] + (None,)

    def add(self, a, b):
        return a[:3] + (None,)

    def cat(self, xs):
        return (xs[0][0], xs[0][1], sum(x[2] for x in xs),
                tuple(x[3] for x in xs))

    def maxpool(self, x, k):
        return x[:3] + (None,)

    def up(self, x):
        return (2 * x[0], 2 * x[1], x[2], None)


def trace(side: int, num_classes: int = NUM_CLASSES, depth=DEPTH):
    """(convs, norms) of the graph at a square input of ``side`` pixels:
    each conv {"ci", "co", "k", "s", "h", "w" (its output), "kind": "conv"
    | "plain" | "head"} in call order, each norm {"c", "h", "w", "parts":
    the indices of the convs its concat's halves come from}."""
    t = _Trace()
    _Walk(t, depth).run((side, side, 3, None), num_classes)
    return t.convs, t.norms


def model_flops(side: int, num_classes: int = NUM_CLASSES,
                depth=DEPTH) -> float:
    """2 x the multiply-adds of the graph's convolutions for one image
    (BN, activations, pools and the decode not counted)."""
    convs, _ = trace(side, num_classes, depth)
    return float(sum(2 * c["h"] * c["w"] * c["k"] ** 2 * c["ci"] * c["co"]
                     for c in convs))


def second_stage_sites(side: int, num_classes: int = NUM_CLASSES,
                       depth=DEPTH):
    """The convs whose concat half cannot fold into a weight (the half
    that comes out of a conv ending in BN + mish): (channels, h, w) each."""
    convs, norms = trace(side, num_classes, depth)
    return [(convs[i]["co"], convs[i]["h"], convs[i]["w"])
            for n in norms for i in n["parts"] if convs[i]["kind"] == "conv"]


def make(seed: int, num_classes: int = NUM_CLASSES, device="cpu",
         depth=DEPTH):
    """Seeded (params, state): kernels N(0, 1/fan_in), every BN (a conv's
    and a concat's) gamma U(0.8, 1.2), beta and mean N(0, 0.1), var U(0.5,
    1.5), head biases N(0, 0.1), made on ``device`` in a few large
    calls."""
    convs, norms = trace(64, num_classes, depth)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    sizes = [c["co"] * c["ci"] * c["k"] ** 2 for c in convs]
    fan = torch.tensor([(c["ci"] * c["k"] ** 2) ** -0.5 for c in convs],
                       device=device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat.mul_(fan.repeat_interleave(torch.tensor(sizes, device=device)))
    widths = ([c["co"] for c in convs if c["kind"] == "conv"]
              + [n["c"] for n in norms])
    n_bn = sum(widths)
    u = torch.rand((2, n_bn), generator=g, device=device)
    nrm = torch.randn((2, n_bn), generator=g, device=device) * 0.1
    n_head = sum(c["co"] for c in convs if c["kind"] == "head")
    head = torch.randn(n_head, generator=g, device=device) * 0.1
    gamma, var = 0.8 + 0.4 * u[0], 0.5 + u[1]
    off = {"w": 0, "bn": 0, "head": 0}

    def bn(width):
        s = slice(off["bn"], off["bn"] + width)
        off["bn"] += width
        return ({"gamma": gamma[s], "beta": nrm[0, s]},
                {"mean": nrm[1, s], "var": var[s]})

    params = {"convs": [], "norms": []}
    state = {"bn": [], "norms": []}
    for c, size in zip(convs, sizes):
        w = flat[off["w"]:off["w"] + size].view(c["co"], c["ci"], c["k"],
                                                c["k"])
        off["w"] += size
        if c["kind"] == "conv":
            p, s = bn(c["co"])
            params["convs"].append({"w": w, **p})
            state["bn"].append(s)
        elif c["kind"] == "head":
            params["convs"].append(
                {"w": w, "b": head[off["head"]:off["head"] + c["co"]]})
            off["head"] += c["co"]
            state["bn"].append(None)
        else:
            params["convs"].append({"w": w})
            state["bn"].append(None)
    for n in norms:
        p, s = bn(n["c"])
        params["norms"].append(p)
        state["norms"].append(s)
    return params, state
