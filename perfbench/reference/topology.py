"""The published YOLOv4 graph (arXiv:2004.10934; darknet cfg/yolov4.cfg;
the tf.keras reference's custom_layers.py), written once against an
abstract op set and frozen with the benchmark.

An op set has ``conv(x, filters, k, down=False, act="leaky", bn=True)``,
``add``, ``concat``, ``maxpool(x, size)`` (stride 1, SAME) and
``upsample`` (nearest, x2).  The same graph drives the shape trace that
counts the benchmark's work (``counts``), the plain float32 forward of
``yolov4`` and its training forward.  Convs are called in darknet's serial
order, so the i-th call is the i-th layer of a ``.weights`` file.
"""

from __future__ import annotations

DEPTH = (1, 2, 8, 8, 4)  # residual units of the five CSP stages


def _csp(ops, x, width: int, units: int, bottleneck: bool):
    route = ops.conv(x, width, 1, act="mish")
    x = ops.conv(x, width, 1, act="mish")
    for _ in range(units):
        y = ops.conv(x, width // 2 if bottleneck else width, 1, act="mish")
        y = ops.conv(y, width, 3, act="mish")
        x = ops.add(x, y)
    x = ops.conv(x, width, 1, act="mish")
    return ops.concat([x, route])


def backbone(ops, x, depth=DEPTH):
    """CSPDarknet53 and SPP: the taps at strides 8, 16 and 32."""
    x = ops.conv(x, 32, 3)
    x = ops.conv(x, 64, 3, down=True)
    x = _csp(ops, x, 64, depth[0], bottleneck=True)
    x = ops.conv(x, 64, 1, act="mish")
    x = ops.conv(x, 128, 3, down=True, act="mish")
    x = _csp(ops, x, 64, depth[1], bottleneck=False)
    x = ops.conv(x, 128, 1, act="mish")
    x = ops.conv(x, 256, 3, down=True, act="mish")
    x = _csp(ops, x, 128, depth[2], bottleneck=False)
    tap8 = x = ops.conv(x, 256, 1, act="mish")
    x = ops.conv(x, 512, 3, down=True, act="mish")
    x = _csp(ops, x, 256, depth[3], bottleneck=False)
    tap16 = x = ops.conv(x, 512, 1, act="mish")
    x = ops.conv(x, 1024, 3, down=True, act="mish")
    x = _csp(ops, x, 512, depth[4], bottleneck=False)
    x = ops.conv(x, 1024, 1, act="mish")
    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    x = ops.conv(x, 512, 1)
    x = ops.concat([ops.maxpool(x, 13), ops.maxpool(x, 9),
                    ops.maxpool(x, 5), x])
    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    tap32 = ops.conv(x, 512, 1)
    return tap8, tap16, tap32


def _five(ops, x, width: int):
    for i in range(5):
        x = ops.conv(x, width if i % 2 == 0 else 2 * width, 1 if i % 2 == 0
                     else 3)
    return x


def neck(ops, taps, num_classes: int):
    """PANet and the three heads: raw grids at strides 8, 16 and 32."""
    tap8, tap16, tap32 = taps
    out = 3 * (num_classes + 5)
    x = ops.upsample(ops.conv(tap32, 256, 1))
    x = ops.concat([ops.conv(tap16, 256, 1), x])
    mid16 = _five(ops, x, 256)
    x = ops.upsample(ops.conv(mid16, 128, 1))
    x = ops.concat([ops.conv(tap8, 128, 1), x])
    mid8 = _five(ops, x, 128)
    head8 = ops.conv(ops.conv(mid8, 256, 3), out, 1, act=None, bn=False)
    x = ops.concat([ops.conv(mid8, 256, 3, down=True), mid16])
    mid16 = _five(ops, x, 256)
    head16 = ops.conv(ops.conv(mid16, 512, 3), out, 1, act=None, bn=False)
    x = ops.concat([ops.conv(mid16, 512, 3, down=True), tap32])
    x = _five(ops, x, 512)
    head32 = ops.conv(ops.conv(x, 1024, 3), out, 1, act=None, bn=False)
    return [head8, head16, head32]


def yolov4(ops, x, num_classes: int, depth=DEPTH):
    return neck(ops, backbone(ops, x, depth), num_classes)


class Shape:
    """A tensor's (H, W, C) in the shape trace."""

    __slots__ = ("h", "w", "c")

    def __init__(self, h, w, c):
        self.h, self.w, self.c = h, w, c


class ConvLayer(tuple):
    """One conv of the graph: (ci, co, k, down, act, bn, h_in, w_in)."""

    @property
    def ci(self):
        return self[0]

    @property
    def co(self):
        return self[1]

    @property
    def k(self):
        return self[2]

    @property
    def down(self):
        return self[3]

    @property
    def act(self):
        return self[4]

    @property
    def bn(self):
        return self[5]

    @property
    def h_out(self):
        return self[6] // 2 if self.down else self[6]

    @property
    def w_out(self):
        return self[7] // 2 if self.down else self[7]


class ShapeOps:
    """The op set of the shape trace: records every conv."""

    def __init__(self):
        self.convs: list = []

    def conv(self, x, filters, k, down=False, act="leaky", bn=True):
        self.convs.append(ConvLayer((x.c, filters, k, down, act, bn, x.h,
                                     x.w)))
        return Shape(x.h // 2, x.w // 2, filters) if down else Shape(
            x.h, x.w, filters)

    def add(self, a, b):
        return a

    def concat(self, xs):
        return Shape(xs[0].h, xs[0].w, sum(v.c for v in xs))

    def maxpool(self, x, size):
        return x

    def upsample(self, x):
        return Shape(2 * x.h, 2 * x.w, x.c)


def conv_layers(side: int, num_classes: int = 80, depth=DEPTH):
    """Every conv of the graph at a square input of ``side`` pixels, in
    darknet's serial order."""
    ops = ShapeOps()
    yolov4(ops, Shape(side, side, 3), num_classes, depth)
    return ops.convs
