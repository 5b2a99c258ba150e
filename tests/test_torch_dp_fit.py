"""``Trainer.fit`` on two gloo ranks (``tests/_torch_dp_worker.py``), with
``num_devices=2`` (the trainer builds the mesh over the process group),
over a seeded ``DataGenerator`` of 7 JPEGs (b4, then a ragged 3) with a
3-line ragged validation set, ``CheckpointCallback`` and ``resume_dir``:

  - only rank 0 writes files and prints, and each step and the validation
    batch make one all-reduce;
  - both ranks end equal, and a fresh trainer's ``fit`` with the same
    ``resume_dir`` restores, on every rank, the state that was written;
  - ranks whose generators draw different batches (unseeded: each rank its
    own seed) make ``fit`` raise on every rank, naming the seed.
"""

import numpy as np
import pytest

from _torch_parity import (IMG, SHALLOW, DPWorkers, dp_leaves, images,
                           remove_at_teardown, torch_params)

C = 3
FIT = dict(img_size=[IMG, IMG, 3], batch_size=2, csp_repeats=list(SHALLOW),
           learning_rate=1e-3, num_devices=2)


def _write_images(folder):
    """7 training and 3 validation JPEGs with 1-3 boxes each, the class
    file, and their annotation lines."""
    import cv2
    rng = np.random.default_rng(3)
    folder.mkdir()
    lines = []
    for i, img in enumerate(images(31, 10, 96)):
        cv2.imwrite(str(folder / f"im{i}.jpg"), img)
        boxes = []
        for _ in range(int(rng.integers(1, 4))):
            x1, y1 = (int(v) for v in rng.integers(0, 50, 2))
            x2, y2 = (int(v) for v in rng.integers(60, 95, 2))
            boxes.append(f"{x1},{y1},{x2},{y2},{int(rng.integers(C))}")
        lines.append(f"im{i}.jpg " + " ".join(boxes))
    classes = folder / "classes.txt"
    classes.write_text("".join(f"c{i}\n" for i in range(C)))
    return lines[:7], lines[7:], str(classes)


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    work = tmp_path_factory.mktemp("dp_fit")
    params, state = torch_params(C)
    lines, val_lines, classes = _write_images(work / "images")
    fit = {"kind": "fit", "config": FIT, "folder": str(work / "images"),
           "classes": classes, "lines": lines, "val_lines": val_lines,
           "seed": 0}
    spec = {"num_classes": C, "scenarios": [
        dict(fit, name="fit"), dict(fit, name="unseeded", seed_per_rank=True)]}
    yield work, DPWorkers(work, spec, params, state, {}).results()
    remove_at_teardown(request, work)


def test_fit_one_writer_and_equal_restores(run):
    work, (r0, r1) = run
    assert (work / "fit" / "ck_r0_0.npz").exists()
    assert not (work / "fit" / "ck_r1_0.npz").exists()
    assert (work / "fit" / "resume" / "latest.npz").exists()
    assert int(r0["fit/printed"]) > 0 and int(r1["fit/printed"]) == 0
    for r in (r0, r1):
        assert int(r["fit/steps"]) == 2
        # The two steps and the ragged validation batch, one each.
        assert int(r["fit/slab"]) == 3
        assert int(r["fit/resumed_steps"]) == 2
    assert float(r0["fit/val_loss"]) == float(r1["fit/val_loss"])
    for name in ("fit", "fit_resumed"):
        for kind in ("params", "state"):
            for a, b in zip(dp_leaves(r0, name, kind),
                            dp_leaves(r1, name, kind)):
                np.testing.assert_array_equal(a, b)
    for kind in ("params", "state"):
        for a, b in zip(dp_leaves(r0, "fit", kind),
                        dp_leaves(r0, "fit_resumed", kind)):
            np.testing.assert_array_equal(a, b)


def test_unseeded_generators_make_fit_raise(run):
    for out in run[1]:
        assert "seed" in str(out["unseeded/error"])
