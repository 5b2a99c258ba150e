"""YOLOv4 network topology, written once against an abstract op set.

The same topology function drives parameter initialisation (shape tracing)
and the forward pass, so the serial order of conv layers — the contract the
darknet ``.weights`` importer relies on — is identical in both.  A copy of
``yolov4tpu.models.topology`` (the port imports nothing of the JAX package).

Architecture (tf.keras reference custom_layers.py:72-198):
  - CSPDarknet53 backbone + SPP
  - PANet neck + 3 raw heads
  - legacy darknet53 (unused by YOLOv4, kept for the reference's surface)
The reference's activation choices are followed exactly, including leaky
stem and pre/post-SPP convs.

``yolov4_p6`` is YOLOv4-P6 of Scaled-YOLOv4 (arXiv:2011.08036; ScaledYOLOv4's
yolov4-large branch, models/yolov4-p6.yaml and the blocks of
models/common.py), on the same op set plus two ops: ``plain_conv`` (a 1x1
conv with no BN, no bias and no activation) and ``norm_act`` (BN + mish
over a concat).  Its serial parameter order is the order of the calls:
every ``conv`` and ``plain_conv`` in one list, every ``norm_act`` in a
second, each in the order the forward reaches it (``_csp``, ``_csp2`` and
``_sppcsp`` say it block by block).
"""

from __future__ import annotations


def csp_block(ops, x, residual_out: int, repeat: int,
              residual_bottleneck: bool = False):
    """Cross-Stage-Partial block (route-split conv first, then main path)."""
    route = ops.conv(x, residual_out, 1, activation="mish")
    x = ops.conv(x, residual_out, 1, activation="mish")
    for _ in range(repeat):
        f1 = residual_out // 2 if residual_bottleneck else residual_out
        y = ops.conv(x, f1, 1, activation="mish")
        y = ops.conv(y, residual_out, 3, activation="mish")
        x = ops.add(x, y)
    x = ops.conv(x, residual_out, 1, activation="mish")
    return ops.concat([x, route])


DEFAULT_CSP_REPEATS = (1, 2, 8, 8, 4)


def cspdarknet53(ops, x, csp_repeats=DEFAULT_CSP_REPEATS):
    """CSPDarknet53 backbone with SPP.

    Returns (route0, route1, route2): taps at strides 8/16/32 with
    256/512/512 channels.  ``csp_repeats`` scales the residual depth of the
    five CSP stages (reference depth (1, 2, 8, 8, 4)).
    """
    r = csp_repeats
    x = ops.conv(x, 32, 3)
    x = ops.conv(x, 64, 3, downsampling=True)

    x = csp_block(ops, x, residual_out=64, repeat=r[0],
                  residual_bottleneck=True)
    x = ops.conv(x, 64, 1, activation="mish")
    x = ops.conv(x, 128, 3, activation="mish", downsampling=True)

    x = csp_block(ops, x, residual_out=64, repeat=r[1])
    x = ops.conv(x, 128, 1, activation="mish")
    x = ops.conv(x, 256, 3, activation="mish", downsampling=True)

    x = csp_block(ops, x, residual_out=128, repeat=r[2])
    x = ops.conv(x, 256, 1, activation="mish")
    route0 = x
    x = ops.conv(x, 512, 3, activation="mish", downsampling=True)

    x = csp_block(ops, x, residual_out=256, repeat=r[3])
    x = ops.conv(x, 512, 1, activation="mish")
    route1 = x
    x = ops.conv(x, 1024, 3, activation="mish", downsampling=True)

    x = csp_block(ops, x, residual_out=512, repeat=r[4])

    x = ops.conv(x, 1024, 1, activation="mish")

    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    x = ops.conv(x, 512, 1)

    # SPP: stride-1 SAME max-pools at 13/9/5 + identity.
    x = ops.concat([
        ops.maxpool(x, 13),
        ops.maxpool(x, 9),
        ops.maxpool(x, 5),
        x,
    ])
    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    route2 = ops.conv(x, 512, 1)
    return route0, route1, route2


def yolov4_neck(ops, routes, num_classes: int):
    """PANet neck + raw detection heads.

    Returns [conv_sbbox, conv_mbbox, conv_lbbox]: raw (un-activated,
    bias-carrying, no-BN) conv outputs with 3*(num_classes+5) channels at
    strides 8/16/32.
    """
    route0, route1, route2 = routes

    route_input = route2
    x = ops.conv(route2, 256, 1)
    x = ops.upsample(x)
    route1 = ops.conv(route1, 256, 1)
    x = ops.concat([route1, x])

    x = ops.conv(x, 256, 1)
    x = ops.conv(x, 512, 3)
    x = ops.conv(x, 256, 1)
    x = ops.conv(x, 512, 3)
    x = ops.conv(x, 256, 1)

    route1 = x
    x = ops.conv(x, 128, 1)
    x = ops.upsample(x)
    route0 = ops.conv(route0, 128, 1)
    x = ops.concat([route0, x])

    x = ops.conv(x, 128, 1)
    x = ops.conv(x, 256, 3)
    x = ops.conv(x, 128, 1)
    x = ops.conv(x, 256, 3)
    x = ops.conv(x, 128, 1)

    route0 = x
    x = ops.conv(x, 256, 3)
    conv_sbbox = ops.conv(x, 3 * (num_classes + 5), 1,
                          activation=None, batch_norm=False)

    x = ops.conv(route0, 256, 3, downsampling=True)
    x = ops.concat([x, route1])

    x = ops.conv(x, 256, 1)
    x = ops.conv(x, 512, 3)
    x = ops.conv(x, 256, 1)
    x = ops.conv(x, 512, 3)
    x = ops.conv(x, 256, 1)

    route1 = x
    x = ops.conv(x, 512, 3)
    conv_mbbox = ops.conv(x, 3 * (num_classes + 5), 1,
                          activation=None, batch_norm=False)

    x = ops.conv(route1, 512, 3, downsampling=True)
    x = ops.concat([x, route_input])

    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    x = ops.conv(x, 512, 1)
    x = ops.conv(x, 1024, 3)
    x = ops.conv(x, 512, 1)

    x = ops.conv(x, 1024, 3)
    conv_lbbox = ops.conv(x, 3 * (num_classes + 5), 1,
                          activation=None, batch_norm=False)

    return [conv_sbbox, conv_mbbox, conv_lbbox]


def yolov4(ops, x, num_classes: int, csp_repeats=DEFAULT_CSP_REPEATS):
    """Full raw-grid forward: image -> [sbbox, mbbox, lbbox] raw conv outputs."""
    routes = cspdarknet53(ops, x, csp_repeats)
    return yolov4_neck(ops, routes, num_classes)


def darknet53(ops, x):
    """Legacy YOLOv3 backbone (reference custom_layers.py:72-97; defined but
    never called by the reference, nor by this package's model).  Returns
    the taps at strides 8, 16 and 32 (256, 512 and 1024 channels)."""

    def residual(x, f1, f2):
        y = ops.conv(x, f1, 1)
        y = ops.conv(y, f2, 3)
        return ops.add(x, y)

    x = ops.conv(x, 32, 3)
    x = ops.conv(x, 64, 3, downsampling=True)
    for _ in range(1):
        x = residual(x, 32, 64)
    x = ops.conv(x, 128, 3, downsampling=True)
    for _ in range(2):
        x = residual(x, 64, 128)
    x = ops.conv(x, 256, 3, downsampling=True)
    for _ in range(8):
        x = residual(x, 128, 256)
    route_1 = x
    x = ops.conv(x, 512, 3, downsampling=True)
    for _ in range(8):
        x = residual(x, 256, 512)
    route_2 = x
    x = ops.conv(x, 1024, 3, downsampling=True)
    for _ in range(4):
        x = residual(x, 512, 1024)
    return route_1, route_2, x


# ---------------------------------------------------------------------------
# YOLOv4-P6 (Scaled-YOLOv4)
# ---------------------------------------------------------------------------

# Residual depth of the six backbone stages and of every neck
# BottleneckCSP2 (yolov4-p6.yaml).
P6_DEPTH = (1, 3, 15, 15, 7, 7, 3)


def _p6_conv(ops, x, filters, k, down=False):
    """Conv of common.py: conv (pad k//2, no bias) -> BN -> mish.  A
    stride-2 3x3 conv's symmetric pad 1 reads the same input rows as the
    op set's top/left pad on an even side."""
    return ops.conv(x, filters, k, downsampling=down, activation="mish")


def _bottleneck(ops, x, c, shortcut: bool):
    y = _p6_conv(ops, _p6_conv(ops, x, c, 1), c, 3)
    return ops.add(x, y) if shortcut else y


def _csp(ops, x, c2: int, n: int):
    """BottleneckCSP(c2, n), c_ = c2 / 2: calls cv1, the n Bottlenecks,
    cv3 (plain), cv2 (plain), the concat's norm, cv4."""
    c_ = c2 // 2
    y = _p6_conv(ops, x, c_, 1)
    for _ in range(n):
        y = _bottleneck(ops, y, c_, True)
    y1 = ops.plain_conv(y, c_)
    y2 = ops.plain_conv(x, c_)
    return _p6_conv(ops, ops.norm_act(ops.concat([y1, y2])), c2, 1)


def _csp2(ops, x, c2: int, n: int):
    """BottleneckCSP2(c2, n), c_ = c2: calls cv1, the n Bottlenecks (no
    shortcut), cv2 (plain), the concat's norm, cv3."""
    x1 = _p6_conv(ops, x, c2, 1)
    y1 = x1
    for _ in range(n):
        y1 = _bottleneck(ops, y1, c2, False)
    y2 = ops.plain_conv(x1, c2)
    return _p6_conv(ops, ops.norm_act(ops.concat([y1, y2])), c2, 1)


def _sppcsp(ops, x, c2: int):
    """SPPCSP(c2), c_ = c2: calls cv1, cv3, cv4, cv5, cv6, cv2 (plain),
    the concat's norm, cv7."""
    x1 = _p6_conv(ops, x, c2, 1)
    x1 = _p6_conv(ops, x1, c2, 3)
    x1 = _p6_conv(ops, x1, c2, 1)
    y = ops.concat([x1, ops.maxpool(x1, 5), ops.maxpool(x1, 9),
                    ops.maxpool(x1, 13)])
    y1 = _p6_conv(ops, _p6_conv(ops, y, c2, 1), c2, 3)
    y2 = ops.plain_conv(x, c2)
    return _p6_conv(ops, ops.norm_act(ops.concat([y1, y2])), c2, 1)


def yolov4_p6(ops, x, num_classes: int, depth=P6_DEPTH):
    """YOLOv4-P6: image -> [P3, P4, P5, P6] raw conv outputs with
    4*(num_classes+5) channels at strides 8/16/32/64.  ``depth``: the six
    backbone stages' Bottlenecks, then the neck's (each BottleneckCSP2),
    every entry at least 1."""
    x = _p6_conv(ops, x, 32, 3)
    x = _p6_conv(ops, x, 64, 3, down=True)                 # /2
    x = _csp(ops, x, 64, depth[0])
    taps = []
    for width, n in zip((128, 256, 512, 1024, 1024), depth[1:6]):
        x = _p6_conv(ops, x, width, 3, down=True)          # /4 ... /64
        x = _csp(ops, x, width, n)
        taps.append(x)
    b8, b16, b32 = taps[1], taps[2], taps[3]
    n = depth[6]

    p6 = _sppcsp(ops, x, 512)                              # 13
    x = ops.upsample(_p6_conv(ops, p6, 512, 1))            # 14, 15
    x = ops.concat([_p6_conv(ops, b32, 512, 1), x])        # 16, 17
    p5 = _csp2(ops, x, 512, n)                             # 18
    x = ops.upsample(_p6_conv(ops, p5, 256, 1))            # 19, 20
    x = ops.concat([_p6_conv(ops, b16, 256, 1), x])        # 21, 22
    p4 = _csp2(ops, x, 256, n)                             # 23
    x = ops.upsample(_p6_conv(ops, p4, 128, 1))            # 24, 25
    x = ops.concat([_p6_conv(ops, b8, 128, 1), x])         # 26, 27
    x = _csp2(ops, x, 128, n)                              # 28
    out3 = _p6_conv(ops, x, 256, 3)                        # 29
    x = ops.concat([_p6_conv(ops, x, 256, 3, down=True), p4])   # 30, 31
    x = _csp2(ops, x, 256, n)                              # 32
    out4 = _p6_conv(ops, x, 512, 3)                        # 33
    x = ops.concat([_p6_conv(ops, x, 512, 3, down=True), p5])   # 34, 35
    x = _csp2(ops, x, 512, n)                              # 36
    out5 = _p6_conv(ops, x, 1024, 3)                       # 37
    x = ops.concat([_p6_conv(ops, x, 512, 3, down=True), p6])   # 38, 39
    x = _csp2(ops, x, 512, n)                              # 40
    out6 = _p6_conv(ops, x, 1024, 3)                       # 41
    out = 4 * (num_classes + 5)
    return [ops.conv(o, out, 1, activation=None, batch_norm=False)
            for o in (out3, out4, out5, out6)]
