"""Timing and profiling helpers: the counterpart of
``yolov4tpu.utils.profiling`` on PyTorch.

``time_fn`` is the timing harness: warm-up calls first, then the host
clock over N calls, each ending in a hard ``torch.cuda.synchronize()`` when
an output is on the card, so that the asynchronous launch does not fake
the numbers.  ``trace`` wraps ``torch.profiler`` and writes a trace that
TensorBoard's profiler plugin or ``chrome://tracing`` reads; ``annotate``
names a region of it.  The chip script's device timers (CUDA events,
CUDA-graph replays) are ``yolov4tpu_torch.tools.measure``.

``span`` is the program's own tracing: the main paths open one at each
layer boundary (``predict_batch`` > ``upload``, ``forward``,
``candidates``, ``nms``; ``train_step`` > ``forward``, ``backward``,
``optimizer``; the prefetch thread's ``ingest.batch``, ``ingest.place``).
A span records only while a ``torch.profiler`` session collects or inside
``recording()``; otherwise it costs a flag read.  Its times are
``time.time_ns()``, the clock the profiler stamps its events with, so a
span lines up with the profiler's trace.  ``spans`` reads the records
back, ``clear_spans`` empties them, and ``trace`` writes its window's to
``spans.json``.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Callable, Optional

import torch
from torch.autograd import profiler as _autograd_profiler


def _sync(out):
    """Wait for the card when any output tensor of ``out`` is on it; the
    CPU's eager ops have finished when they return."""
    from ..train import leaves
    for t in leaves(out):
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 2,
            **kwargs) -> dict:
    """Warm up, then time ``fn(*args, **kwargs)``; returns stats in seconds:
    ``mean_s``, ``p50_s``, ``min_s``, ``max_s``, ``iters`` and ``warmup_s``
    (the warm-up calls together, kernel builds included)."""
    out = None
    t_warm = time.perf_counter()
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    _sync(out)
    t_warm = time.perf_counter() - t_warm

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    return {
        "mean_s": sum(times) / n,
        "p50_s": times[n // 2],
        "min_s": times[0],
        "max_s": times[-1],
        "iters": n,
        "warmup_s": t_warm,
    }


@contextlib.contextmanager
def trace(logdir: Optional[str] = None):
    """``torch.profiler`` scope over the host and, where there is one, the
    card; on exit it writes ``<host>_<pid>.<time>.pt.trace.json`` under
    ``logdir``, and the program's spans of the window (``spans``, one
    object a span, times in ns on the trace's clock) to
    ``logdir/spans.json``.  A no-op when ``logdir`` is None, so call sites
    can stay in production code."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    lo = time.time_ns()
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()   # so that every span's device time reads
    window = spans(lo, time.time_ns())
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump([r.as_dict() for r in window], f)


def annotate(name: str):
    """A named region on the trace's timeline."""
    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------

CAPACITY = 65536                  # records kept; the oldest go first
_records: collections.deque = collections.deque(maxlen=CAPACITY)
_records_lock = threading.Lock()
_seq = itertools.count()
_open = threading.local()         # each thread's stack of open spans
_recorders = 0                    # recording() scopes open, any thread


class Span:
    """One recorded span.  ``start_ns``/``end_ns`` are ``time.time_ns()``;
    ``parent`` is the ``seq`` of the span that enclosed it on the same
    ``thread`` (``threading.get_ident()``), or None; ``id`` is the id it was
    opened with, else its parent's; ``counts`` what the site counted;
    ``device_ms`` the card's time from its start event to its end event on
    the stream it was opened on (``spans`` fills it in once both events
    have completed; None before that and for spans without events)."""

    FIELDS = ("name", "id", "parent", "thread", "start_ns", "end_ns",
              "counts", "device_ms", "seq")
    __slots__ = FIELDS + ("_events",)

    def __init__(self, name, id, parent, counts):
        self.name, self.id, self.parent, self.counts = name, id, parent, counts
        self.thread = threading.get_ident()
        self.seq = next(_seq)
        self.start_ns = self.end_ns = None
        self.device_ms = self._events = None

    def _resolve(self) -> None:
        ev = self._events
        if ev is not None and ev[1] is not None and ev[0].query() \
                and ev[1].query():
            self.device_ms = ev[0].elapsed_time(ev[1])
            self._events = None

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}


class _Recorder:
    """The context manager of a span that records: on entry the start
    stamp (then the start event), on exit the end event (then the end
    stamp) and the record."""

    __slots__ = ("rec", "_device")

    def __init__(self, name, id, device, counts):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        parent = stack[-1] if stack else None
        if id is None and parent is not None:
            id = parent.id
        self.rec = Span(name, id, parent.seq if parent else None, counts)
        self._device = (torch.device(device) if device is not None
                        else None)

    def __enter__(self):
        rec = self.rec
        _open.stack.append(rec)
        rec.start_ns = time.time_ns()
        if self._device is not None and self._device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(self._device))
            rec._events = (start, None)
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec._events is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self._device))
            rec._events = (rec._events[0], end)
        rec.end_ns = time.time_ns()
        _open.stack.pop()
        with _records_lock:
            _records.append(rec)
        return False

    def count(self, **counts) -> None:
        self.rec.counts.update(counts)


class _Off:
    """The span that records nothing; falsy, so a site can skip counting."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self) -> bool:
        return False

    def count(self, **counts) -> None:
        pass


_OFF = _Off()


def span(name: str, id=None, device=None, **counts):
    """A context manager that records ``name``'s span on this thread (see
    ``Span``).  ``device``: a CUDA device to also time the span on its
    current stream with two CUDA events, never synchronised.  The value
    ``with`` binds takes further ``count(**counts)``; it is falsy when the
    span records nothing.  Records only while a ``torch.profiler`` session
    collects or inside ``recording()``, and never while ``torch.export``
    or ``torch.compile`` traces."""
    if not (_recorders or _autograd_profiler._is_profiler_enabled) \
            or torch.compiler.is_compiling():
        return _OFF
    return _Recorder(name, id, device, counts)


@contextlib.contextmanager
def recording():
    """Record spans in this scope (from every thread) without a profiler."""
    global _recorders
    with _records_lock:
        _recorders += 1
    try:
        yield
    finally:
        with _records_lock:
            _recorders -= 1


def spans(lo: Optional[int] = None, hi: Optional[int] = None) -> list:
    """The recorded spans whose interval meets [lo, hi] (``time.time_ns``
    stamps; None is open), in order of start, with ``device_ms`` filled in
    where both events have completed."""
    with _records_lock:
        recs = list(_records)
    out = [r for r in recs if (lo is None or r.end_ns >= lo)
           and (hi is None or r.start_ns <= hi)]
    for r in out:
        r._resolve()
    out.sort(key=lambda r: (r.start_ns, r.seq))
    return out


def clear_spans() -> None:
    with _records_lock:
        _records.clear()
