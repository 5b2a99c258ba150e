"""YOLOv4's forward in plain float32 PyTorch: the folded inference forward
and the training forward with batch statistics.

Weights are the benchmark's dictionaries, ``{"convs": [{"w", "gamma",
"beta"} | {"w", "b"}]}`` and ``{"bn": [{"mean", "var"} | None]}``, kernels
OIHW, in darknet's serial order (``topology``).  Layer semantics follow the
tf.keras reference: a downsampling conv pads one zero row and column at the
top and left and runs stride 2 VALID; BatchNorm has Keras' epsilon 1e-3;
mish is x * tanh(softplus(x)); leaky has slope 0.1.  Images are NHWC in
[0, 1]; the raw grids come back NHWC.

Float32 matmuls and convolutions run with TF32 off (``strict_fp32``).
``quant`` rounds every tensor a layer reads or makes (its input, kernel
and bias, the conv's output and the bias added to it, the normalised
output, each step of the activation, a residual sum) to a lower
precision, as a network computed in that precision holds them
(``lowp``).
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import topology

BN_EPS = 1e-3


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


def mish(x):
    return x * torch.tanh(F.softplus(x))


def mish_rounded(x, q):
    """mish as a network held in a lower precision computes it, one
    rounding per operation: u = e^min(x, 20), n = u^2 + 2u, x * n / (n + 2)
    (x itself above 20), the identity tanh(softplus(x)) = n / (n + 2)."""
    u = q(torch.exp(torch.clamp(x, max=20.0)))
    n = q(q(u * u) + q(2.0 * u))
    return torch.where(x > 20.0, x, q(x * q(n / q(n + 2.0))))


def activate(y, act, q=None):
    if act == "mish":
        return mish(y) if q is None else mish_rounded(y, q)
    if act == "leaky":
        return F.leaky_relu(y, 0.1)
    return y


def conv2d(x, w, k: int, down: bool):
    if down:
        return F.conv2d(F.pad(x, (1, 0, 1, 0)), w, stride=2)
    return F.conv2d(x, w, padding=k // 2)


def fold_bn(params, state):
    """Each BN conv as one conv with bias: w * g / sqrt(v + eps) and
    beta - m * g / sqrt(v + eps)."""
    out = []
    for p, bn in zip(params["convs"], state["bn"]):
        if bn is None:
            out.append((p["w"].float(), p["b"].float()))
            continue
        s = p["gamma"].float() / torch.sqrt(bn["var"].float() + BN_EPS)
        out.append((p["w"].float() * s[:, None, None, None],
                    p["beta"].float() - bn["mean"].float() * s))
    return out


def _same(t):
    return t


class _Shape:
    quant = None

    def q(self, t):
        return t if self.quant is None else self.quant(t)

    def add(self, a, b):
        return self.q(a + b)

    def concat(self, xs):
        return torch.cat(xs, dim=1)

    def maxpool(self, x, size):
        return F.max_pool2d(x, size, stride=1, padding=size // 2)

    def upsample(self, x):
        return F.interpolate(x, scale_factor=2, mode="nearest")


class _FoldedOps(_Shape):
    def __init__(self, folded, quant=None):
        self.layers, self.quant, self.i = folded, quant, 0

    def conv(self, x, filters, k, down=False, act="leaky", bn=True):
        w, b = self.layers[self.i]
        self.i += 1
        q = self.q
        y = q(q(conv2d(q(x), q(w), k, down)) + q(b).view(1, -1, 1, 1))
        return q(activate(y, act, self.quant))


def _train_conv(x, w, gamma, beta, k, down, act, quant, affine=False):
    """One conv with BatchNorm over the batch.  ``affine`` normalises as
    y * scale + shift, scale = gamma / sqrt(var + eps) and shift = beta -
    mean * scale, each rounded by ``quant``: the form in which a network
    held in a lower precision may apply it, where y - mean is never
    formed."""
    q = quant or _same
    y = q(conv2d(q(x), q(w), k, down))
    mean = y.mean(dim=(0, 2, 3), keepdim=True)
    var = y.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    g, b = gamma.view(1, -1, 1, 1), beta.view(1, -1, 1, 1)
    if affine:
        scale = g * torch.rsqrt(var + BN_EPS)
        y = q(q(y * q(scale)) + q(b - mean * scale))
    else:
        y = q((y - mean) * torch.rsqrt(var + BN_EPS) * g + b)
    return q(activate(y, act))


def _head_conv(x, w, b, quant):
    q = quant or _same
    return q(F.conv2d(q(x), q(w)) + q(b).view(1, -1, 1, 1))


class _TrainOps(_Shape):
    """Convs with BatchNorm over the batch's statistics; each conv is one
    checkpointed segment, so only its input is kept for the backward and
    a full-size float32 step fits on the card."""

    def __init__(self, convs, quant=None, remat=True, affine=False):
        self.convs, self.quant, self.remat, self.i = convs, quant, remat, 0
        self.affine = affine

    def _run(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def conv(self, x, filters, k, down=False, act="leaky", bn=True):
        p = self.convs[self.i]
        self.i += 1
        if not bn:
            return self._run(
                lambda x_, w_, b_: _head_conv(x_, w_, b_, self.quant),
                x, p["w"], p["b"])
        return self._run(
            lambda x_, w_, g_, b_: _train_conv(x_, w_, g_, b_, k, down, act,
                                               self.quant, self.affine),
            x, p["w"], p["gamma"], p["beta"])


def _nhwc(outs):
    return [o.permute(0, 2, 3, 1).contiguous() for o in outs]


def forward_folded(folded, images, num_classes: int, quant=None,
                   depth=topology.DEPTH):
    """Inference raw grids of NHWC float images over ``fold_bn``'s
    layers."""
    with strict_fp32(), torch.no_grad():
        x = images.float().permute(0, 3, 1, 2).contiguous()
        return _nhwc(topology.yolov4(_FoldedOps(folded, quant), x,
                                     num_classes, depth))


def forward_train(params, images, num_classes: int, quant=None,
                  depth=topology.DEPTH, remat=True, affine=False):
    """Training raw grids (BatchNorm over this batch) of NHWC float
    images; differentiable in ``params``' tensors."""
    x = images.float().permute(0, 3, 1, 2).contiguous()
    return _nhwc(topology.yolov4(
        _TrainOps(params["convs"], quant, remat, affine), x, num_classes,
        depth))
