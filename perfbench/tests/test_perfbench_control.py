"""The control of ``correct`` at a size a test run can hold: the
precision below the configuration's (the reference computed in float8
put in the program's place, for inference and for training) reads well
above the program as configured, on the same seeds, in the numbers the
cells hold it by.  At 128 px with one residual unit a stage the error has
few layers to grow over, so the margin is smaller than the cells' (chip
readings in PERF.md)."""

import pytest

from _tiny import OFF, TRAIN, make_root, readings, run


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("control"), side=128)


@pytest.mark.parametrize("seed", [11, 12])
def test_inference_control_reads_above_the_program(root, seed, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = run(root, OFF, seed, variants=("control",), every=True)
    prog, ctrl = readings(out), out["variants"]["control"]
    assert ctrl["det_ratio"] > 3 * prog["det_ratio"]
    assert ctrl["det_gap"] > 3 * prog["det_gap"]
    assert ctrl["nms_breaches"] > prog["nms_breaches"]


def test_training_control_reads_above_the_program(root, tmp_path,
                                                  monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = run(root, TRAIN, 5, variants=("control",), every=True)
    prog, ctrl = readings(out), out["variants"]["control"]
    assert ctrl["grad_total"] > 3 * prog["grad_total"]
