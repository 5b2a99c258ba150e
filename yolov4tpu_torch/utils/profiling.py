"""Timing and profiling helpers: the counterpart of
``yolov4tpu.utils.profiling`` on PyTorch.

``time_fn`` is the timing harness: warm-up calls first, then the host
clock over N calls, each ending in a hard ``torch.cuda.synchronize()`` when
an output is on the card, so that the asynchronous launch does not fake
the numbers.  ``trace`` wraps ``torch.profiler`` and writes a trace that
TensorBoard's profiler plugin or ``chrome://tracing`` reads; ``annotate``
names a region of it.  The chip script's device timers (CUDA events,
CUDA-graph replays) are ``yolov4tpu_torch.tools.measure``.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable, Optional

import torch


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
    ``logdir``.  A no-op when ``logdir`` is None, so call sites can stay in
    production code."""
    if logdir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)):
        yield


def annotate(name: str):
    """A named region on the trace's timeline."""
    return torch.profiler.record_function(name)
