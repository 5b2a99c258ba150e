"""The port's host tools ``utils.profiling`` and ``utils.metrics`` against
the JAX package's (``yolov4tpu.utils.profiling``, ``yolov4tpu.utils.metrics``):

  - ``time_fn`` returns the JAX keys, times ``iters`` calls after the
    warm-up ones, and its statistics are ordered;
  - ``trace(None)`` starts no profiler and writes nothing; ``trace(dir)``
    writes a trace holding the regions ``annotate`` names;
  - ``MetricsLogger`` writes the JAX logger's CSV (same header, same rows
    but the ``wall`` seconds) and the same TensorBoard scalars.  Its rank-0
    writes on a two-rank trainer are in ``test_torch_distribute.py``.
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4tpu.utils import metrics as jmetrics
from yolov4tpu.utils import profiling as jprofiling
from yolov4tpu_torch.utils import metrics, profiling

ENTRIES = [{"epoch": 0, "loss": 2.5, "time": 1.25, "val_loss": 3.0},
           {"epoch": 1, "loss": np.float32(1.75), "time": 1.5,
            "val_loss": 2.0}]


def test_time_fn_keys_and_iters():
    calls = []

    def fn(x):
        calls.append(1)
        return {"y": [x + 1, None]}

    got = profiling.time_fn(fn, torch.ones(3), iters=5, warmup=2)
    want = jprofiling.time_fn(lambda x: x + 1, jnp.ones(3), iters=5,
                              warmup=2)
    assert list(got) == list(want)
    assert got["iters"] == 5 and len(calls) == 7
    assert 0 <= got["min_s"] <= got["p50_s"] <= got["max_s"]
    assert got["min_s"] <= got["mean_s"] <= got["max_s"]
    assert got["warmup_s"] >= 0


def test_trace_none_is_a_no_op(tmp_path):
    with profiling.trace(None):
        assert not torch.autograd.profiler._is_profiler_enabled
        torch.ones(2) * 2
    assert list(tmp_path.iterdir()) == []


def test_trace_writes_a_trace_with_the_annotated_region(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        assert torch.autograd.profiler._is_profiler_enabled
        with profiling.annotate("port_region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(logdir.glob("*.pt.trace.json"))
    assert len(files) == 1
    names = {e.get("name") for e in
             json.loads(files[0].read_text())["traceEvents"]}
    assert "port_region" in names


def _scalars(log_dir):
    """{tag: [(step, value), ...]} of the one event file in ``log_dir``."""
    from tensorboard.backend.event_processing.event_file_loader import \
        EventFileLoader
    (path,) = log_dir.glob("events.out.tfevents.*")
    out = {}
    for event in EventFileLoader(str(path)).Load():
        for v in event.summary.value:
            value = (v.simple_value if v.HasField("simple_value")
                     else float(np.frombuffer(v.tensor.tensor_content,
                                              np.float32)[0])
                     if v.tensor.tensor_content else v.tensor.float_val[0])
            out.setdefault(v.tag, []).append((event.step, value))
    return out


@pytest.fixture
def no_tensorflow(monkeypatch):
    """tensorboard's no-TensorFlow mode (its stub file writer): where
    TensorFlow is installed, tensorboard imports it, which takes ~13 s."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))


def test_metrics_logger_writes_the_jax_loggers_files(tmp_path,
                                                     no_tensorflow):
    loggers = {"port": metrics.MetricsLogger(str(tmp_path / "port")),
               "jax": jmetrics.MetricsLogger(str(tmp_path / "jax"))}
    for logger in loggers.values():
        for entry in ENTRIES:
            logger(None, entry)
        logger.log_step(7, {"loss": 0.5, "note": "skipped"})
        logger.close()
    rows = {k: (tmp_path / k / "metrics.csv").read_text().splitlines()
            for k in loggers}
    assert rows["port"][0] == rows["jax"][0] == "epoch,loss,time,val_loss,wall"
    assert len(rows["port"]) == len(rows["jax"]) == 1 + len(ENTRIES)
    for got, want in zip(rows["port"][1:], rows["jax"][1:]):
        assert got.split(",")[:-1] == want.split(",")[:-1]
        assert float(got.split(",")[-1]) >= 0
    got, want = _scalars(tmp_path / "port"), _scalars(tmp_path / "jax")
    assert sorted(got) == sorted(want) == ["epoch/loss", "epoch/time",
                                           "epoch/val_loss", "step/loss"]
    assert got == want
