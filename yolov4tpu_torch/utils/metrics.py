"""Structured training metrics, CSV always and TensorBoard when available:
the counterpart of ``yolov4tpu.utils.metrics`` (which already writes
through torch's ``SummaryWriter``).

``MetricsLogger`` is a ``Trainer.fit`` callback that records each epoch's
metrics (and, through ``log_step``, per-step scalars) to a CSV file and,
when ``torch.utils.tensorboard`` imports, to TensorBoard event files.  On a
data-parallel trainer rank 0 alone writes (``parallel.on_rank0``).
"""

from __future__ import annotations

import csv
import os
import time
from typing import Optional

from ..parallel.mesh import on_rank0


class MetricsLogger:
    """Callback: ``MetricsLogger(dir)`` -> ``Trainer.fit(callbacks=[...])``.

    Writes ``dir/metrics.csv`` with one row per epoch (the epoch entry's
    keys, sorted, and ``wall``: seconds since the logger was made) and
    mirrors the scalars to TensorBoard when it imports.  The event file is
    opened at the first write, so on a mesh only rank 0 has one.
    """

    def __init__(self, log_dir: str, tensorboard: bool = True):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self.csv_path = os.path.join(log_dir, "metrics.csv")
        self._csv_fields: Optional[list] = None
        self._t0 = time.time()
        self._tensorboard = tensorboard
        self._tb = None

    def _writer(self):
        """The TensorBoard writer, opened at the first call; None when
        TensorBoard is off or does not import."""
        if self._tb is None and self._tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter
            except ImportError:
                self._tensorboard = False
                return None
            self._tb = SummaryWriter(log_dir=self.log_dir)
        return self._tb

    def _write_csv(self, row: dict):
        fields = sorted(row.keys())
        new_file = (self._csv_fields is None
                    and not os.path.exists(self.csv_path))
        if self._csv_fields is None:
            self._csv_fields = fields
        with open(self.csv_path, "a", newline="") as f:
            w = csv.DictWriter(f, fieldnames=self._csv_fields,
                               extrasaction="ignore")
            if new_file:
                w.writeheader()
            w.writerow(row)

    def log_step(self, step: int, metrics: dict):
        """Optional fine-grained per-step scalars (TensorBoard only); on a
        mesh, call it on rank 0."""
        tb = self._writer()
        if tb is not None:
            for k, v in metrics.items():
                try:
                    tb.add_scalar(f"step/{k}", float(v), step)
                except (TypeError, ValueError):
                    pass

    def __call__(self, trainer, entry: dict):
        on_rank0(getattr(trainer, "mesh", None), lambda: self._log(entry))

    def _log(self, entry: dict):
        row = {k: (float(v) if isinstance(v, (int, float)) else v)
               for k, v in entry.items()}
        row["wall"] = round(time.time() - self._t0, 3)
        self._write_csv(row)
        tb = self._writer()
        if tb is not None:
            epoch = int(entry.get("epoch", 0))
            for k, v in entry.items():
                if isinstance(v, (int, float)) and k != "epoch":
                    tb.add_scalar(f"epoch/{k}", float(v), epoch)
            tb.flush()

    def close(self):
        if self._tb is not None:
            self._tb.close()
