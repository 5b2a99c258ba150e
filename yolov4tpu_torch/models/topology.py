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
