"""Threaded producer/consumer helper for host-IO / device-compute overlap.

A copy of ``yolov4tpu.utils.stream``.  The GIL is released inside cv2
decode/resize and numpy copies, so a single producer thread loading batch
N+1 overlaps the card's inference of batch N: an IO+compute pipeline takes
max(host, device) per batch instead of host + device.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")


def threaded_map(fn: Callable[[T], U], items: Iterable[T],
                 depth: int = 2) -> Iterator[U]:
    """Yield ``fn(item)`` for each item, computed ``depth`` ahead in a
    background thread.  Exceptions in ``fn`` re-raise at the consumer.

    Abandoning the generator (break / consumer exception / GC) sets a stop
    event and drains the queue so the producer never blocks forever holding
    decoded batches (the cancellation contract of data.pipeline.prefetch).
    """
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def put_until_stopped(msg):
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer():
        try:
            for item in items:
                if stop.is_set():
                    return
                put_until_stopped(("ok", fn(item)))
        except BaseException as e:  # noqa: BLE001 — surfaced to consumer
            put_until_stopped(("err", e))
            return
        put_until_stopped(("end", None))

    threading.Thread(target=producer, daemon=True).start()
    try:
        while True:
            kind, item = q.get()
            if kind == "err":
                raise item
            if kind == "end":
                return
            yield item
    finally:
        stop.set()
        # Unblock a producer mid-put by draining whatever is queued.
        while True:
            try:
                q.get_nowait()
            except queue.Empty:
                break
