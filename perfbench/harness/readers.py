"""What the metrics' readers share: the traced window's events and spans."""

from __future__ import annotations

from . import counts, peaks
from . import trace as tr


def window_events(ctx, kind=None, match=None):
    """Device events inside the window, clipped: (name, start, end)."""
    lo, hi = ctx.run.window
    out = []
    for name, k, s, e in ctx.run.trace.events:
        if e <= lo or s >= hi or (kind and k != kind):
            continue
        if match and not any(m in name for m in match):
            continue
        out.append((name, max(s, lo), min(e, hi)))
    return out


def busy_s(ctx) -> float:
    lo, hi = ctx.run.window
    return sum(e - s for s, e in tr.busy_intervals(ctx.run.trace.events, lo,
                                                    hi)) / 1e9


def idle_share(ctx):
    """100 x (1 - union of device activity / window), traced runs only."""
    if ctx.run.trace is None:
        return None
    return 100.0 * (1.0 - busy_s(ctx) / ctx.window_s)


def mfu(ctx, passes: int):
    """``passes`` x the model FLOPs of each image done in the traced window
    (2 x the multiply-adds of the published graph's 110 convolutions at
    the cell's size, from the frozen conv list), over the window at the
    bf16 peak, in percent."""
    if ctx.run.trace is None:
        return None
    cfg = ctx.cell.config
    flops = passes * images(ctx) * counts.model_flops(
        cfg["img_size"], cfg["num_classes"], tuple(cfg["csp_repeats"]))
    return 100.0 * flops / (ctx.window_s * peaks.BF16_FLOPS)


def images(ctx) -> int:
    return sum(c["images"] for c in ctx.run.calls)


def span_s(ctx, name: str) -> float:
    return sum(e - s for n, s, e, _ in ctx.run.spans.items if n == name) / 1e9
