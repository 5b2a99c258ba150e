"""One run of one cell: the traffic's loop drives the program, the
metrics' readers reduce what it recorded, and the result is the line the
benchmark prints."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from . import manifest


@dataclass
class Run:
    """What a loop hands back.  Times are ``time.time_ns`` stamps.

    calls: one dict per timed call or step, with "start", "end" and
      "images"; window: (start, end) of the measured window; first_call:
      the start of the first timed call (the end of set-up); checks: the
      numbers compared for ``correct``; trace: the ``DeviceTrace`` of a
      traced run and spans the benchmark's host ``Spans``; extra: what a
      reader may need besides (work counts of the inputs), and under
      "variants" the numbers of the readings asked for beside the
      program's (``perfbench/readings.py``).
    """
    calls: list
    window: tuple
    first_call: int
    checks: dict
    attempted: int
    failed: int
    memory_peak: int
    device: dict
    trace: object = None
    spans: object = None
    extra: dict = field(default_factory=dict)


@dataclass
class Context:
    """What a metric's reader reads: the run, its cell and the set-up
    time in seconds."""
    run: Run
    cell: manifest.Cell
    setup_s: float

    @property
    def window_s(self) -> float:
        return (self.run.window[1] - self.run.window[0]) / 1e9


def judge(checks: dict, limits: dict, every: bool = False):
    """correct, and each number that has a limit beside it; the others
    are printed on an earlier line."""
    rows = {k: {"value": checks.get(k), "limit": v}
            for k, v in limits.items()}
    if every:
        rows.update({k: {"value": v, "limit": limits.get(k)}
                     for k, v in checks.items() if k not in limits})
    others = {k: v for k, v in checks.items() if k not in limits}
    if others:
        print(f"readings without a limit: {others}", flush=True)
    ok = bool(rows) and all(
        r["limit"] is not None and isinstance(r["value"], (int, float))
        and math.isfinite(r["value"]) and r["value"] <= r["limit"]
        for r in rows.values())
    return ok, rows


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             device, t0_ns: int, variants=(), all_checks=False) -> dict:
    """Run the cell once and return the result line as a dict; with
    ``variants`` (readings for the limits), their numbers under
    "variants"."""
    run = manifest.loop(cell).run(cell, seed=seed, seconds=seconds,
                                  trace=trace, device=device,
                                  variants=tuple(variants))
    ctx = Context(run, cell, (run.first_call - t0_ns) / 1e9)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = manifest.reader(cell, m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    correct, rows = judge(run.checks, cell.limits, all_checks)
    out = {"correct": correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": run.device}
    if trace and run.trace is not None:
        from . import trace as tr
        lo, hi = run.window
        busy = tr.busy_intervals(run.trace.events, lo, hi)
        out["device"] = dict(run.device,
                             busy_s=sum(e - s for s, e in busy) / 1e9,
                             window_s=(hi - lo) / 1e9)
        out["breakdown"] = tr.breakdown(run.trace.events, run.spans.items,
                                        lo, hi)
    if variants:
        out["variants"] = run.extra.get("variants", {})
    out["checks"] = rows
    return out
