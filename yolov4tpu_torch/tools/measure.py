"""Timing on the card, the training path's wgrad and BN + activation
shapes and the folded forward's epilogue shapes, and the BN + activation
backward's float32 yardstick: the helpers ``chip_smoke.py``,
``tools/wgrad_probe.py`` and the card's tests share."""

from __future__ import annotations

import collections
import statistics

import torch


def cuda_ms(fn, n: int, repeats: int = 5, warmup: int = 2) -> float:
    """Median over ``repeats`` of the mean time of ``n`` calls, in ms, from
    CUDA events around the calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def graph_ms(fn, n: int = 20, repeats: int = 5) -> float:
    """Device time of one call of ``fn``, in ms: ``n`` calls captured in a
    CUDA graph (after warm-up on a side stream) and the graph's replays
    timed by ``cuda_ms``, so the host's launch cost between calls is not
    in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    return cuda_ms(graph.replay, n=1, repeats=repeats) / n


def kernel_times(fn, calls: int = 20) -> dict:
    """Device time per call of ``fn`` in each kernel it launches, in ms, by
    the profiler's kernel name (``torch.profiler`` over ``calls`` calls
    after one warm-up call)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {ev.key: ev.device_time_total / calls / 1e3
            for ev in prof.key_averages()
            if getattr(ev, "device_time_total", 0)}


def wgrad_shapes(side: int = 416, num_classes: int = 80, csp_repeats=None):
    """Counter of (H, Ci, Co) over the 3x3 stride-1 convs of the training
    forward (the convs pallas_wgrad routes through the kernel)."""
    from ..models import network, topology

    class Trace(network._InitOps):
        def __init__(self):
            super().__init__(None)
            self.s1 = collections.Counter()

        def conv(self, x, filters, kernel_size, downsampling=False,
                 activation="leaky", batch_norm=True):
            if kernel_size == 3 and not downsampling:
                self.s1[(x.h, x.c, filters)] += 1
            return super().conv(x, filters, kernel_size, downsampling,
                                activation, batch_norm)

    trace = Trace()
    topology.yolov4(trace, network._ShapeVal(side, side, 3), num_classes,
                    csp_repeats or topology.DEFAULT_CSP_REPEATS)
    return trace.s1


def epilogue_shapes(side: int = 416, batch: int = 64, num_classes: int = 80,
                    csp_repeats=None, s2d_stem: bool = True) -> list:
    """(NCHW shape, activation) of every conv epilogue of the folded
    forward (``network.apply_folded``) of a ``batch`` of ``side``-square
    images, in order: the forward run on meta tensors, which allocate and
    compute nothing."""
    from ..models import network, topology

    class Record(network._FoldedApplyOps):
        def _epilogue(self, y, b, activation):
            seen.append((tuple(y.shape), activation or "linear"))
            return super()._epilogue(y, b, activation)

    depth = csp_repeats or topology.DEFAULT_CSP_REPEATS
    folded = {"convs": [
        {"w": torch.empty((s.filters, s.in_ch, s.kernel_size, s.kernel_size),
                          device="meta"),
         "b": torch.empty((s.filters,), device="meta")}
        for s in network.conv_specs(num_classes, depth)]}
    folded = network.prepare_folded(folded, "meta", torch.bfloat16)
    images = torch.empty((batch, 3, side, side), device="meta")
    seen = []
    topology.yolov4(Record(folded, torch.bfloat16, s2d_stem=s2d_stem),
                    images.contiguous(memory_format=torch.channels_last),
                    num_classes, depth)
    return seen


def bn_act_shapes(side: int = 608, batch: int = 8, num_classes: int = 80,
                  csp_repeats=None) -> list:
    """(NCHW shape, activation) of every BN conv of the training forward
    (``ops.bn_act`` sites: each conv but the three heads), in order."""
    return [(shape, act) for shape, act in epilogue_shapes(
        side, batch, num_classes, csp_repeats, s2d_stem=False)
        if act != "linear"]


def bn_act_float32(y, gamma, beta, mean, var, activation: str):
    """The yardstick of the BN + activation kernels' backward: float32
    autograd of the forward as ``y``'s dtype rounds it.  The batch
    statistics from y's values in float32; scale, shift, y * scale and
    the activation's input z rounded to y's dtype in value, with their
    gradients passed straight through (so act' is taken at the z the
    forward used); the activation in float32.  Returns (out, new_mean,
    new_var) as ``ops.bn_act.bn_act`` does."""
    from ..ops.bn_act import BN_EPS, BN_MOMENTUM
    from ..ops.epilogue import _activate

    def rounded(x):
        return x + (x.to(y.dtype).float() - x).detach()

    yf = y.float()
    m = yf.mean(dim=(0, 2, 3))
    v = torch.clamp(yf.square().mean(dim=(0, 2, 3)) - m.square(), min=0.0)
    inv = torch.rsqrt(v + BN_EPS)
    scale = rounded(gamma * inv).view(1, -1, 1, 1)
    shift = rounded(beta - m * gamma * inv).view(1, -1, 1, 1)
    z = rounded(rounded(yf * scale) + shift)
    return (_activate(z, activation),
            (BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * m).detach(),
            (BN_MOMENTUM * var + (1 - BN_MOMENTUM) * v).detach())
