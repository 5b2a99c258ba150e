"""The readers of the program's own spans (``harness/program_trace.py``):
traced tiny runs on the CPU report the host-time ones as finite numbers
and leave out the device times (None on the CPU); untraced runs report
only the end-to-end metrics; and a program without spans gives none of
them, without a fault."""

import math

import pytest

from _tiny import OFF, TRAIN, make_root, run

HOST = {OFF: {"upload_host_ms.infer"},
        TRAIN: {"ingest_busy_share.train", "dispatch_idle_share.train"}}
DEVICE = {OFF: {"forward_dev_ms.infer", "candidates_dev_ms.infer",
                "nms_dev_ms.infer"},
          TRAIN: {"forward_dev_ms.train", "backward_dev_ms.train",
                  "optimizer_dev_ms.train"}}
E2E = {OFF: {"infer_img_per_s", "setup_s"},
       TRAIN: {"train_img_per_s", "setup_s"}}


@pytest.mark.parametrize("cell", [OFF, TRAIN])
def test_traced_runs_read_the_programs_spans(tmp_path, monkeypatch, cell):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    root = make_root(tmp_path)
    traced = run(root, cell, trace=True)["metrics"]
    for name in HOST[cell]:
        value = traced[name]["value"]
        assert math.isfinite(value) and value >= 0, (name, value)
    assert not DEVICE[cell] & set(traced)
    if cell == TRAIN:
        assert traced["dispatch_idle_share.train"]["value"] <= \
            traced["idle_share.train"]["value"] + 1e-9
        assert 0 < traced["ingest_busy_share.train"]["value"] <= 100
    assert set(run(root, cell)["metrics"]) == E2E[cell]


def test_a_program_without_spans_reports_none_of_them(tmp_path,
                                                      monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    from yolov4tpu_torch.utils import profiling
    monkeypatch.delattr(profiling, "spans")
    root = make_root(tmp_path)
    traced = run(root, OFF, trace=True)["metrics"]
    assert not (HOST[OFF] | DEVICE[OFF]) & set(traced)
    assert "h2d_ms.infer" in traced
