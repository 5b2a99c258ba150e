"""The program's spans (``utils.profiling.span``) on the CPU, tiny model:

  - with no profiler and no ``recording()``, ``predict_batch``,
    ``train_step`` and ``prefetch`` record nothing, create no CUDA event
    and open no ``record_function`` of theirs;
  - under ``torch.profiler`` or ``recording()``, each records its tree:
    ``predict_batch`` > ``upload``, ``forward``, ``candidates``, ``nms``
    under one id; ``train_step`` > ``forward``, ``backward``, ``optimizer``
    under its ``global_step``; the producer thread's ``ingest.batch`` and
    ``ingest.place`` under the batch's number;
  - outputs and losses are bit-identical with recording on and off;
  - the spans' stamps are the profiler's clock; ``trace`` writes
    ``spans.json``; ``device_ms`` is None on the CPU;
  - the buffer is bounded, ids and parents are per thread, and nothing
    records while ``torch.export`` traces.
"""

import dataclasses
import json
import threading

import cv2
import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from yolov4tpu_torch.api import Yolov4
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.data.pipeline import DataGenerator, prefetch
from yolov4tpu_torch.models import network
from yolov4tpu_torch.train import Trainer, leaves
from yolov4tpu_torch.utils import profiling

torch.set_num_threads(1)

SHALLOW = (1, 1, 1, 1, 1)
CFG = YoloConfig(img_size=(64, 64, 3), csp_repeats=SHALLOW, batch_size=2,
                 nms_pre_top_k=64)
INFER = ("upload", "forward", "candidates", "nms")
TRAIN = ("forward", "backward", "optimizer")
NAMES = {"predict_batch", "train_step", "ingest.batch", "ingest.place",
         *INFER, *TRAIN}
MODES = {"profiler": lambda: profile(activities=[ProfilerActivity.CPU]),
         "recording": profiling.recording}


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


@pytest.fixture(scope="module")
def model(tiny_classes):
    return Yolov4(None, tiny_classes, config=CFG, device="cpu")


@pytest.fixture(scope="module")
def u8():
    return np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def generator(tmp_path_factory, tiny_classes):
    """A generator over four 48x64 JPEGs with one or two boxes each."""
    folder = tmp_path_factory.mktemp("spans_data")
    rng = np.random.default_rng(1)
    lines = []
    for i in range(4):
        cv2.imwrite(str(folder / f"img{i}.jpg"),
                    rng.integers(0, 256, (48, 64, 3), dtype=np.uint8))
        lines.append(f"img{i}.jpg 4,6,30,40,{i % 3}"
                     + (" 20,10,60,44,1" if i % 2 else ""))
    return DataGenerator(lines, tiny_classes, str(folder), config=CFG,
                         seed=0, use_native=False)


def make_trainer(**config):
    params, state, _ = network.init(3, 64, seed=0, csp_repeats=SHALLOW)
    return Trainer(dataclasses.replace(CFG, **config), 3, params, state,
                   device="cpu")


@pytest.fixture(scope="module")
def batch(generator):
    return generator.get_batch(0)


def take(feed, n):
    """n batches of a ``prefetch`` feed, then close it and wait for its
    producer thread to end, so that it records nothing in a later test."""
    before = set(threading.enumerate())
    out = [next(feed) for _ in range(n)]
    feed.close()
    (producer,) = [t for t in set(threading.enumerate()) - before
                   if t.name.endswith("(producer)")]
    producer.join(timeout=30)
    assert not producer.is_alive()
    return out


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def assert_nested(child, parent):
    assert child.parent == parent.seq and child.id == parent.id
    assert child.thread == parent.thread
    assert parent.start_ns <= child.start_ns <= child.end_ns <= parent.end_ns


def test_nothing_records_without_a_profiler(model, u8, generator, batch,
                                            monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event was created")

    opened = []
    real_init = torch.autograd.profiler.record_function.__init__

    def spy(self, name, *a, **k):
        opened.append(name)
        real_init(self, name, *a, **k)

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__",
                        spy)
    trainer = make_trainer()
    assert not torch.autograd.profiler._is_profiler_enabled
    model.predict_batch(u8)
    trainer.train_step(batch)
    take(prefetch(generator, transform=trainer._prefetch_place), 3)
    assert profiling.spans() == []
    assert not NAMES & set(opened)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_predict_batch_records_its_stages(model, u8, mode):
    with MODES[mode]():
        out = model.predict_batch(u8)
    got = profiling.spans()
    (call,) = by_name(got, "predict_batch")
    assert call.parent is None and call.counts == {"images": 2}
    assert call.thread == threading.get_ident()
    stages = [s for s in got if s is not call]
    assert [s.name for s in stages] == list(INFER)
    for s in stages:
        assert_nested(s, call)
    for a, b in zip(stages, stages[1:]):
        assert a.end_ns <= b.start_ns
    assert int(out[3].sum()) >= 0


@pytest.mark.parametrize("mode", sorted(MODES))
def test_train_step_records_its_stages(batch, mode):
    trainer = make_trainer()
    trainer.train_step(batch)
    with MODES[mode]():
        trainer.train_step(batch)
    got = profiling.spans()
    (step,) = by_name(got, "train_step")
    assert step.id == 1 and trainer.global_step == 2
    assert step.counts == {"images": 2} and step.parent is None
    stages = [s for s in got if s is not step]
    assert [s.name for s in stages] == list(TRAIN)
    for s in stages:
        assert_nested(s, step)


def test_sat_and_accumulation_repeat_the_stages(batch):
    """Two micro-batches, each with the SAT pass's own forward and
    backward before the update's: eight stages, then one optimizer."""
    trainer = make_trainer(sat_epsilon=0.01, grad_accum_steps=2)
    with profiling.recording():
        trainer.train_step(batch)
    got = profiling.spans()
    (step,) = by_name(got, "train_step")
    assert [s.name for s in got if s is not step] == \
        ["forward", "backward"] * 4 + ["optimizer"]
    for s in got:
        if s is not step:
            assert_nested(s, step)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_prefetch_records_on_its_thread(generator, mode):
    trainer = make_trainer()
    with MODES[mode]():
        feed = prefetch(generator, transform=trainer._prefetch_place)
        take(feed, 3)
    got = profiling.spans()
    loads, places = by_name(got, "ingest.batch"), by_name(got, "ingest.place")
    assert [s.id for s in loads[:3]] == [0, 1, 2]
    assert [s.id for s in places[:3]] == [0, 1, 2]
    assert {s.thread for s in loads + places} != {threading.get_ident()}
    assert len({s.thread for s in loads + places}) == 1
    for load, place in zip(loads, places):
        assert load.parent is None and place.parent is None
        assert load.counts == {"images": 2} and load.end_ns <= place.start_ns


def test_outputs_are_bit_identical_with_recording_on_and_off(model, u8,
                                                             batch):
    off = model.predict_batch(u8)
    with profiling.recording():
        on = model.predict_batch(u8)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    trainers = make_trainer(), make_trainer()
    losses = [float(trainers[0].train_step(batch)["loss"])]
    with profiling.recording():
        losses.append(float(trainers[1].train_step(batch)["loss"]))
    assert losses[0] == losses[1]
    for a, b in zip(leaves(trainers[0].params), leaves(trainers[1].params)):
        assert torch.equal(a, b)
    assert by_name(profiling.spans(), "train_step")


def test_spans_share_the_profilers_clock(model, u8):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        model.predict_batch(u8)
    (fwd,) = by_name(profiling.spans(), "forward")
    convs = [e.start_ns() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CPU
             and e.name() == "aten::conv2d"]
    assert len(convs) >= 50
    slack = 1_000_000
    assert fwd.start_ns - slack <= min(convs)
    assert max(convs) <= fwd.end_ns + slack


def test_profile_sets_the_flag_the_spans_read():
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert not flag()
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag()
        with profiling.span("probe") as rec:
            assert rec
    assert not flag()
    with profiling.span("probe") as rec:
        assert not rec
    assert [s.name for s in profiling.spans()] == ["probe"]


def test_trace_writes_spans_json(model, u8, tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        model.predict_batch(u8)
    rows = json.loads((logdir / "spans.json").read_text())
    assert [r["name"] for r in rows] == ["predict_batch", *INFER]
    assert set(rows[0]) == set(profiling.Span.FIELDS)
    assert all(r["device_ms"] is None for r in rows)
    assert len({r["id"] for r in rows}) == 1
    assert list(logdir.glob("*.pt.trace.json"))


def test_device_ms_is_none_on_the_cpu(model, u8):
    with profiling.recording():
        model.predict_batch(u8)
        with profiling.span("cpu", device=torch.device("cpu")):
            torch.ones(4).sum()
    got = profiling.spans()
    assert len(got) == 6 and all(s.device_ms is None for s in got)


def test_window_ids_and_the_bound():
    with profiling.recording():
        with profiling.span("a", id="x"):
            with profiling.span("b", n=1) as b:
                b.count(m=2)
        for i in range(profiling.CAPACITY + 5):
            with profiling.span("c", id=i):
                pass
    got = profiling.spans()
    assert len(got) == profiling.CAPACITY
    assert got[0].id == 5 and got[-1].id == profiling.CAPACITY + 4
    mid = got[len(got) // 2]
    window = profiling.spans(mid.start_ns, mid.end_ns)
    assert mid in window and all(
        s.end_ns >= mid.start_ns and s.start_ns <= mid.end_ns for s in window)
    profiling.clear_spans()
    with profiling.recording():
        with profiling.span("a", id="x"):
            with profiling.span("b", n=1) as b:
                b.count(m=2)
    a, b = profiling.spans()
    assert b.id == "x" and b.parent == a.seq and b.counts == {"n": 1, "m": 2}


def test_threads_record_their_own_trees():
    """More threads than cores open nested spans at once under a short
    switch interval: every record is kept, and each child's parent is the
    span its own thread opened around it."""
    import sys
    workers, rounds = 16, 200
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(k):
            for r in range(rounds):
                with profiling.span("outer", id=(k, r)):
                    with profiling.span("inner"):
                        pass

        with profiling.recording():
            threads = [threading.Thread(target=work, args=(k,))
                       for k in range(workers)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    got = profiling.spans()
    assert len(got) == 2 * workers * rounds
    outer = {s.seq: s for s in got if s.name == "outer"}
    for s in got:
        if s.name == "inner":
            assert_nested(s, outer[s.parent])


def test_nothing_records_while_export_traces(monkeypatch):
    with profiling.recording():
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with profiling.span("traced") as rec:
            assert not rec
        monkeypatch.undo()
        with profiling.span("eager") as rec:
            assert rec
    assert [s.name for s in profiling.spans()] == ["eager"]
