"""``Yolov4.distribute(axis="spatial")`` on two gloo ranks at 64 px, each a
process of ``tests/_torch_dp_worker.py`` (rank 1's params offset before
``distribute``), against references computed here on the same numpy
inputs and density-calibrated weights:

  - every rank's raw grids against the JAX package's single-device
    ``_raw_fn`` (rtol 1e-4, atol 1e-5, as ``tests/test_api.py`` holds its
    spatial program) and the port's single-device facade;
  - ``predict_batch`` at b2, b1 and a uint8 b3 against the JAX package's
    ``predict_batch`` (1e-3 per box and score, equal classes and counts)
    and the port's single-device facade (rtol 1e-4, atol 1e-5);
  - 29 halo exchanges a forward at this depth and one more ``all_gather``
    for the grids, and the rows received;
  - ``nms_impl="pallas"`` against the port's single-device facade (which
    ``test_torch_eval_path.py`` holds to the JAX package's within 1e-3 per
    box; a second JAX program here would take the file past its time);
  - ``quantize`` after ``distribute``: rank 1 calibrates its own weights
    but serves rank 0's scales and int8 model, held to the port's
    single-device int8 facade (int8 against the JAX package's int8 is
    held to rel-RMS 1e-2 of the grids, ``test_torch_quantize.py``, not
    to 1e-3 per box);
  - ``export_prediction``: rank 0 alone writes, its files on disk for
    rank 1 when the call returns, equal to the single-device facade's.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, DPWorkers, assert_detections_equal,
                           images, port_calibrated, remove_at_teardown)
from yolov4tpu import api as japi
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_to_jax

C = 3
KW = dict(img_size=[IMG, IMG, 3], csp_repeats=list(SHALLOW), num_devices=2)
# name -> (seed, batch, wire)
BATCHES = {"b2": (31, 2, "float"), "b1": (32, 1, "float"),
           "b3": (33, 3, "uint8")}
EXPORT_BS = 2


def _batch(name):
    seed, b, wire = BATCHES[name]
    u8 = images(seed, b)
    return u8 if wire == "uint8" else u8.astype(np.float32) / 255.0


def _float(x):
    return x if x.dtype == np.float32 else x.astype(np.float32) / 255.0


def _write_folder(folder, n: int = 4):
    import cv2
    folder.mkdir()
    lines = []
    for i, img in enumerate(images(41, n, 96)):
        cv2.imwrite(str(folder / f"im{i}.jpg"), img[:80])
        lines.append(f"im{i}.jpg 10,12,{40 + i},{50 + i},{i % C}")
    (folder / "anno.txt").write_text("\n".join(lines) + "\n")
    (folder / "classes.txt").write_text("".join(f"c{i}\n" for i in range(C)))


def _stacked(fn, names):
    """``fn`` of every named batch stacked into one call (one JAX compile;
    inference rows are independent), split back by name."""
    whole = [np.asarray(o) for o in fn(np.concatenate(
        [_float(_batch(n)) for n in names]))]
    out, start = {}, 0
    for n in names:
        b = BATCHES[n][1]
        out[n] = [o[start:start + b] for o in whole]
        start += b
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    work = tmp_path_factory.mktemp("spatial")
    params, state, _ = port_calibrated(C)
    folder = work / "images"
    _write_folder(folder)
    classes, anno = str(folder / "classes.txt"), str(folder / "anno.txt")
    calib = images(0, 4).astype(np.float32) / 255.0
    names = sorted(BATCHES)
    spec = {"num_classes": C, "scenarios": [
        {"name": "sp", "kind": "spatial", "config": KW, "classes": classes,
         "offset": 0.25, "raw": ["b2"], "batches": names, "pallas": ["b2"],
         "calib": "calib", "int8": ["b2", "b3"], "annotation": anno,
         "folder": str(folder), "bs": EXPORT_BS}]}
    arrays = {n: _batch(n) for n in names}
    workers = DPWorkers(work, spec, params, state, {},
                        arrays=dict(arrays, calib=calib))

    # The references, computed while the ranks run.
    cfg = YoloConfig(**KW).replace(num_devices=1)
    ref = {}
    for impl in ("pallas", "fast"):
        m = tapi.Yolov4(None, classes, config=cfg.replace(nms_impl=impl),
                        device="cpu")
        m.sync_params(params, state)
        ref[impl] = {n: [o.numpy() for o in m.predict_batch(x)]
                     for n, x in arrays.items()}
    ref["raw"] = [o.numpy() for o in m._raw(torch.from_numpy(arrays["b2"]))]
    m.export_prediction(anno, str(work / "pred_single"), str(folder),
                        bs=EXPORT_BS, verbose=False)
    m.quantize(calib_imgs=calib)
    ref["int8"] = {n: [o.numpy() for o in m.predict_batch(arrays[n])]
                   for n in ("b2", "b3")}
    ref["scales"] = np.concatenate([m._act_scales[k]
                                    for k in sorted(m._act_scales)])
    jm = japi.Yolov4(None, classes, config=JaxConfig(
        img_size=(IMG, IMG, 3), csp_repeats=SHALLOW))
    jm.sync_params(*params_to_jax(params, state))
    jax = {"fast": _stacked(jm.predict_batch, names)}
    jax["raw"] = [np.asarray(o) for o in jm._raw_fn(jm._folded,
                                                    arrays["b2"])]
    yield work, workers.results(), ref, jax
    remove_at_teardown(request, work)


def _outputs(r, prefix, n: int = 4):
    return [r[f"{prefix}/{i}"] for i in range(n)]


def test_raw_grids_match_the_single_device_forward(run):
    _, ranks, ref, jax = run
    for r in ranks:
        got = _outputs(r, "sp/raw/b2", 3)
        for g, j, s in zip(got, jax["raw"], ref["raw"]):
            assert g.shape == j.shape and g.dtype == np.float32
            np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-5)
            np.testing.assert_allclose(g, s, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", sorted(BATCHES))
def test_predict_batch_matches_jax_and_single(run, name):
    _, ranks, ref, jax = run
    b = BATCHES[name][1]
    assert ref["fast"][name][3].min() >= 5   # detections survive NMS
    for r in ranks:
        got = _outputs(r, f"sp/{name}")
        assert got[0].shape == (b, 100, 4)
        for d, s in zip(got, ref["fast"][name]):
            assert d.dtype == s.dtype
            np.testing.assert_allclose(d, s, rtol=1e-4, atol=1e-5)
        assert_detections_equal(got, jax["fast"][name], box_atol=1e-3,
                                score_atol=1e-3)


def test_halo_exchanges_of_a_forward(run):
    """29 exchanges (the shallow depth's 26 3x3 convs and 3 pools) and one
    gather a call, on every rank; the rows received add up to the
    neighbour-only count across the one boundary (two a 3x3 conv, two a
    downsample, 12 a set of pools, at every level that has them)."""
    _, ranks, _, _ = run
    for r in ranks:
        for key in ["sp/raw/b2"] + [f"sp/{n}" for n in BATCHES] + [
                "sp_pallas/b2", "sp_int8/b2", "sp_int8/b3"]:
            assert int(r[f"{key}/exchanges"]) == 29, key
            assert int(r[f"{key}/all_gather"]) == 30, key
    rows = [int(r["sp/b2/rows"]) for r in ranks]
    # 19 3x3 stride-1 convs, 7 downsamples, pools of 6, 4 and 2 rows a
    # side; the 2-row grid gives the pools one row each way.
    assert rows == [19 + 3, 19 + 2 * 7 + 3]


def test_pallas_matches_single(run):
    _, ranks, ref, _ = run
    for r in ranks:
        got = _outputs(r, "sp_pallas/b2")
        for d, s in zip(got, ref["pallas"]["b2"]):
            np.testing.assert_allclose(d, s, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["b2", "b3"])
def test_quantize_after_distribute_serves_rank0(run, name):
    _, ranks, ref, _ = run
    assert not all(np.array_equal(a, b) for a, b in
                   zip(ref["fast"][name], ref["int8"][name]))
    for r in ranks:
        np.testing.assert_array_equal(r["sp_int8/scales"], ref["scales"])
        for d, s in zip(_outputs(r, f"sp_int8/{name}"), ref["int8"][name]):
            np.testing.assert_allclose(d, s, rtol=1e-4, atol=1e-5)


def test_export_prediction_rank0_writes(run):
    work, (r0, r1), _, _ = run
    assert not (work / "sp" / "pred_r1").exists()
    want_files = [f"im{i}.txt" for i in range(4)]
    assert sorted(p.name for p in (work / "sp" / "pred_r0").iterdir()) == \
        want_files
    assert list(r1["sp/rank0_files"]) == want_files
    # 4 images in batches of 2: 30 all_gathers a batch, every rank.
    assert int(r0["sp/export_all_gather"]) == 60
    assert int(r1["sp/export_all_gather"]) == 60
    for name in want_files:
        got, want = ((work / d / name).read_text().split()
                     for d in ("sp/pred_r0", "pred_single"))
        assert len(got) == len(want) > 0
        assert got[::6] == want[::6]     # class names
        np.testing.assert_allclose(
            np.array([float(v) for i, v in enumerate(got) if i % 6]),
            np.array([float(v) for i, v in enumerate(want) if i % 6]),
            rtol=1e-4, atol=1e-3)
