"""What the program's own spans say about a traced window.

The program records spans at its layer boundaries while a
``torch.profiler`` session collects (``yolov4tpu_torch.utils.profiling``:
``predict_batch`` > ``upload``, ``forward``, ``candidates``, ``nms``;
``train_step`` > ``forward``, ``backward``, ``optimizer``; the prefetch
thread's ``ingest.batch`` and ``ingest.place``), so a ``--trace 1`` run's
``DeviceTrace`` switches them on for exactly its window.  Their stamps are
``time.time_ns``, the device trace's clock.  A program that records no
spans gives None, and so does every reader of them.
"""

from __future__ import annotations

from . import trace as tr


def window_spans(ctx):
    """The program's spans that meet the traced window, or None (an
    untraced run, or a program without spans)."""
    if ctx.run.trace is None:
        return None
    try:
        from yolov4tpu_torch.utils.profiling import spans
    except ImportError:
        return None
    return spans(*ctx.run.window) or None


def _roots(got) -> dict:
    """{seq: the outermost span enclosing that span on its thread}."""
    by_seq = {s.seq: s for s in got}
    out = {}
    for s in got:
        top = s
        while top.parent in by_seq:
            top = by_seq[top.parent]
        out[s.seq] = top
    return out


def per_call_ms(ctx, root: str, stage: str, device: bool):
    """The mean over the window's ``root`` spans (one a call or step) of
    the ``stage`` spans under each, summed: their ``device_ms`` with
    ``device``, else their host time in ms.  None where a device time is
    missing (on the CPU, or its events not completed)."""
    got = window_spans(ctx)
    if got is None:
        return None
    roots = _roots(got)
    per = {s.seq: 0.0 for s in got if s.name == root}
    for s in got:
        top = roots[s.seq]
        if s.name != stage or top.name != root:
            continue
        ms = s.device_ms if device else (s.end_ns - s.start_ns) / 1e6
        if ms is None:
            return None
        per[top.seq] += ms
    return sum(per.values()) / len(per) if per else None


def host_union(ctx, names, root=None):
    """The union of the host intervals of the window's spans named in
    ``names`` (only those under a ``root`` span, when given), clipped to
    the window, merged and sorted; None without spans."""
    got = window_spans(ctx)
    if got is None:
        return None
    roots = _roots(got)
    picked = [(None, None, s.start_ns, s.end_ns) for s in got
              if s.name in names
              and (root is None or roots[s.seq].name == root)]
    return tr.busy_intervals(picked, *ctx.run.window)


def overlap_ns(a, b) -> int:
    """The length of the intersection of two merged, sorted lists of
    intervals."""
    total, i, j = 0, 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, e - s)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def device_idle(ctx):
    """The device's idle stretches of the window (``trace.gaps`` between
    the union of its kernels, copies and sets)."""
    lo, hi = ctx.run.window
    return tr.gaps(tr.busy_intervals(ctx.run.trace.events, lo, hi), lo, hi)
