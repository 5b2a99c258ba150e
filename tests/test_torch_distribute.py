"""``Yolov4.distribute(axis="batch")`` on two gloo ranks, each a process of
``tests/_torch_dp_worker.py``, against two references computed here on
the same numpy inputs and weights (density-calibrated, so the detections
are many and none sits near the threshold): the port's single-device
facade, within the JAX tests' tolerances for sharded inference (rtol
1e-4, atol 1e-5, ``tests/test_api.py``, ``tests/test_quantize.py``), and
the JAX package's single-device ``predict_batch``, within the port's
contract with it (1e-3 per box and score, ``tests/test_torch_api.py``).

  - ``predict_batch`` at b8 and at ragged b3, b5 (uint8 wire) and b1
    (rank 1 holds only padding), one ``all_gather`` a call, on every rank
    the whole batch's outputs, although rank 1 started from other params;
  - ``quantize`` after ``distribute``: rank 1 calibrates its own weights
    but serves rank 0's int8 model;
  - ``export_prediction``: rank 0 alone writes, its files are on disk for
    rank 1 when the call returns, and they agree with the single-device
    facade's;
  - ``fit`` on a distributed facade over a two-rank trainer, with
    ``MetricsLogger`` (one CSV, one row per epoch, one event file) and
    ``EvalMapCallback`` (every rank syncs and predicts, rank 0 scores).
"""

import numpy as np
import pytest

from _torch_parity import (IMG, SHALLOW, DPWorkers, assert_detections_equal,
                           dp_leaves, images, port_calibrated)
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_to_jax

C = 3
KW = dict(img_size=[IMG, IMG, 3], csp_repeats=list(SHALLOW), batch_size=2,
          learning_rate=1e-3, num_devices=2)
# name -> (seed, batch, wire): b1 leaves rank 1 nothing but padding.
BATCHES = {"b8": (11, 8, "float"), "b3": (12, 3, "float"),
           "b5": (13, 5, "uint8"), "b1": (14, 1, "float")}
EXPORT_BS = 3


def _batch(name):
    seed, b, wire = BATCHES[name]
    u8 = images(seed, b)
    return u8 if wire == "uint8" else u8.astype(np.float32) / 255.0


def _write_folder(folder, n: int = 8):
    """``n`` JPEGs of 96x80 with one box each, their annotation file and
    the class file."""
    import cv2
    folder.mkdir()
    lines = []
    for i, img in enumerate(images(21, n, 96)):
        cv2.imwrite(str(folder / f"im{i}.jpg"), img[:80])
        lines.append(f"im{i}.jpg 10,12,{40 + i},{50 + i},{i % C}")
    (folder / "anno.txt").write_text("\n".join(lines) + "\n")
    (folder / "anno4.txt").write_text("\n".join(lines[:4]) + "\n")
    (folder / "classes.txt").write_text("".join(f"c{i}\n" for i in range(C)))
    return lines


def _read_predictions(folder):
    """{file name: [(class, [score, x1, y1, x2, y2]), ...]}."""
    out = {}
    for path in sorted(folder.iterdir()):
        rows = [line.split() for line in path.read_text().splitlines()]
        out[path.name] = [(r[0], [float(v) for v in r[1:]]) for r in rows]
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    work = tmp_path_factory.mktemp("distribute")
    params, state, _ = port_calibrated(C)
    folder = work / "images"
    lines = _write_folder(folder)
    classes, anno = str(folder / "classes.txt"), str(folder / "anno.txt")
    calib = images(0, 4).astype(np.float32) / 255.0
    spec = {"num_classes": C, "scenarios": [
        {"name": "dist", "kind": "distribute", "config": KW,
         "classes": classes, "offset": 0.25, "batches": sorted(BATCHES),
         "calib": "calib", "annotation": anno, "folder": str(folder),
         "bs": EXPORT_BS,
         "fit": {"annotation": str(folder / "anno4.txt"),
                 "lines": lines[:2], "epochs": 2}}]}
    arrays = {name: _batch(name) for name in BATCHES}
    workers = DPWorkers(work, spec, params, state, {},
                        arrays=dict(arrays, calib=calib))

    # The references, computed while the ranks run.
    ref = tapi.Yolov4(None, classes, config=YoloConfig(**KW).replace(
        num_devices=1), device="cpu")
    ref.sync_params(params, state)
    single = {n: [o.numpy() for o in ref.predict_batch(x)]
              for n, x in arrays.items()}
    ref.export_prediction(anno, str(work / "pred_single"), str(folder),
                          bs=EXPORT_BS, verbose=False)
    ref.quantize(calib_imgs=calib)
    single_int8 = {n: [o.numpy() for o in ref.predict_batch(x)]
                   for n, x in arrays.items()}
    jm = japi.Yolov4(None, classes, config=JaxConfig(
        img_size=(IMG, IMG, 3), csp_repeats=SHALLOW))
    jm.sync_params(*params_to_jax(params, state))
    # One JAX call (one compile): inference rows are independent.
    names = sorted(BATCHES)
    stacked = np.concatenate([x if x.dtype == np.float32
                              else x.astype(np.float32) / 255.0
                              for x in (arrays[n] for n in names)])
    whole = [np.asarray(o) for o in jm.predict_batch(stacked)]
    jax_out, start = {}, 0
    for n in names:
        b = BATCHES[n][1]
        jax_out[n] = [o[start:start + b] for o in whole]
        start += b
    return work, workers.results(), single, single_int8, jax_out


def _outputs(r, prefix, name):
    return [r[f"{prefix}/{name}/{i}"] for i in range(4)]


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_distributed_predict_batch_matches_single_and_jax(run, name):
    _, ranks, single, _, jax_out = run
    b = BATCHES[name][1]
    assert single[name][3].min() >= 5   # detections survive NMS
    for r in ranks:
        got = _outputs(r, "dist", name)
        assert int(r[f"dist/{name}/all_gather"]) == 1
        assert got[0].shape == (b, 100, 4)
        for d, s in zip(got, single[name]):
            assert d.dtype == s.dtype
            np.testing.assert_allclose(d, s, rtol=1e-4, atol=1e-5)
        assert_detections_equal(got, jax_out[name], box_atol=1e-3,
                                score_atol=1e-3)


@pytest.mark.parametrize("name", ["b8", "b3"])
def test_quantize_composes_with_distribute(run, name):
    _, ranks, single, single_int8, _ = run
    # int8 changes the detections, so the comparison below is of int8.
    assert not all(np.array_equal(a, b) for a, b in
                   zip(single[name], single_int8[name]))
    for r in ranks:
        assert int(r[f"dist_int8/{name}/all_gather"]) == 1
        for d, s in zip(_outputs(r, "dist_int8", name), single_int8[name]):
            np.testing.assert_allclose(d, s, rtol=1e-4, atol=1e-5)


def test_export_prediction_rank0_writes(run):
    work, (r0, r1), _, _, _ = run
    assert not (work / "dist" / "pred_r1").exists()
    got = _read_predictions(work / "dist" / "pred_r0")
    want = _read_predictions(work / "pred_single")
    assert sorted(got) == [f"im{i}.txt" for i in range(8)]
    assert list(r1["dist/rank0_files"]) == sorted(got)
    # 8 images in batches of 3, 3 and 2: one all_gather each, every rank.
    assert int(r0["dist/export_all_gather"]) == 3
    assert int(r1["dist/export_all_gather"]) == 3
    assert sorted(want) == sorted(got)
    for key in want:
        assert [c for c, _ in got[key]] == [c for c, _ in want[key]]
        assert len(got[key]) > 0
        g = np.array([v for _, v in got[key]])
        w = np.array([v for _, v in want[key]])
        np.testing.assert_allclose(g[:, 0], w[:, 0], rtol=1e-4, atol=1e-5)
        # Boxes in pixels of the 96x80 images: 1e-5 of the side.
        np.testing.assert_allclose(g[:, 1:], w[:, 1:], rtol=1e-4, atol=1e-3)


def test_fit_on_a_distributed_facade_logs_and_evaluates(run):
    """Every rank syncs and predicts in EvalMapCallback (the same
    all_gathers), rank 0 alone scores and writes, and MetricsLogger leaves
    one CSV with a row per epoch and one event file."""
    work, (r0, r1), _, _, _ = run
    assert len(r0["dist_fit/maps"]) == 2 and len(r1["dist_fit/maps"]) == 0
    assert all(0.0 <= m <= 1.0 for m in r0["dist_fit/maps"])
    # Two evaluations of 4 images in batches of 2.
    assert int(r0["dist_fit/all_gather"]) == 4
    assert int(r1["dist_fit/all_gather"]) == 4
    np.testing.assert_array_equal(r0["dist_fit/losses"],
                                  r1["dist_fit/losses"])
    for kind in ("params", "state"):
        for a, b in zip(dp_leaves(r0, "dist_fit", kind),
                        dp_leaves(r1, "dist_fit", kind)):
            np.testing.assert_array_equal(a, b)
    logs = work / "dist" / "logs"
    rows = (logs / "metrics.csv").read_text().splitlines()
    assert rows[0] == "epoch,loss,time,wall"
    assert [int(float(r.split(",")[0])) for r in rows[1:]] == [0, 1]
    assert len(list(logs.glob("events.out.tfevents.*"))) == 1
    assert sorted(p.name for p in (work / "dist" / "eval" / "pred_result")
                  .iterdir()) == [f"im{i}.txt" for i in range(4)]
