"""``Yolov4.distribute(axis="spatial")`` where the coarse grid does not
split evenly, each rank a gloo process of ``tests/_torch_dp_worker.py``
(rank 1's params offset before ``distribute``), held to the port's
single-device facade (which ``test_torch_spatial_dist.py`` and the
inference tests hold to the JAX package's) at rtol 1e-4, atol 1e-5:

  - 96 px on two ranks: the 3-row coarse grid splits 2/1;
  - 96 px on three ranks: one coarse row a rank, so the 13-pool's 6-row
    halo crosses two neighbours (rank 0 takes rows from ranks 1 and 2);
  - 64 px on three ranks: the 2-row coarse grid leaves rank 2 no rows; it
    runs a phantom strip and makes every collective, and every rank gets
    the whole outputs;

raw grids and ``predict_batch`` (float and int8), 29 halo exchanges and
one gather a forward on every rank.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (SHALLOW, DPWorkers, images, port_calibrated,
                           remove_at_teardown)
from yolov4tpu_torch import api as tapi
from yolov4tpu_torch.config import YoloConfig

C = 3
# scenario -> (world, side)
RUNS = {"u96": (2, 96), "t96": (3, 96), "t64": (3, 64)}


def _kw(world, side):
    return dict(img_size=[side, side, 3], csp_repeats=list(SHALLOW),
                num_devices=world)


@pytest.fixture(scope="module")
def run(tmp_path_factory, tiny_classes, request):
    params, state, _ = port_calibrated(C)
    calib = images(0, 4).astype(np.float32) / 255.0
    arrays = {"calib": calib}
    for side in (64, 96):
        arrays[f"x{side}"] = images(50 + side, 2, side).astype(
            np.float32) / 255.0
    workers, folders = {}, []
    for world in (2, 3):
        scenarios = [
            {"name": name, "kind": "spatial", "config": _kw(world, side),
             "classes": tiny_classes, "offset": 0.25, "raw": [f"x{side}"],
             "batches": [f"x{side}"], "calib": "calib",
             "int8": [f"x{side}"]}
            for name, (w, side) in RUNS.items() if w == world]
        folders.append(tmp_path_factory.mktemp(f"spatial{world}"))
        workers[world] = DPWorkers(
            folders[-1],
            {"num_classes": C, "scenarios": scenarios}, params, state, {},
            world=world, arrays=arrays)

    ref = {}
    for side in (64, 96):
        m = tapi.Yolov4(None, tiny_classes, device="cpu", config=YoloConfig(
            **_kw(1, side)))
        m.sync_params(params, state)
        x = arrays[f"x{side}"]
        ref[side] = {"raw": [o.numpy() for o in m._raw(torch.from_numpy(x))],
                     "fast": [o.numpy() for o in m.predict_batch(x)]}
        m.quantize(calib_imgs=calib)
        ref[side]["int8"] = [o.numpy() for o in m.predict_batch(x)]
    yield {w: wk.results() for w, wk in workers.items()}, ref
    for folder in folders:
        remove_at_teardown(request, folder)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_uneven_spatial_equals_single(run, name):
    results, ref = run
    world, side = RUNS[name]
    ranks = results[world]
    assert len(ranks) == world
    key = f"x{side}"
    for r in ranks:
        for prefix, want, n in ((f"{name}/raw/{key}", ref[side]["raw"], 3),
                                (f"{name}/{key}", ref[side]["fast"], 4),
                                (f"{name}_int8/{key}", ref[side]["int8"], 4)):
            assert int(r[f"{prefix}/exchanges"]) == 29, prefix
            assert int(r[f"{prefix}/all_gather"]) == 30, prefix
            for i in range(n):
                got = r[f"{prefix}/{i}"]
                assert got.shape == want[i].shape
                np.testing.assert_allclose(got, want[i], rtol=1e-4,
                                           atol=1e-5)


def test_rows_received_follow_the_plan(run):
    """Rows received a forward, rank by rank: on three ranks at 96 px the
    pools' halos take both other ranks' rows at the coarse grid; a rank
    without rows receives none."""
    results, _ = run
    rows = {name: [int(r[f"{name}/x{side}/rows"])
                   for r in results[world]]
            for name, (world, side) in RUNS.items()}
    # 19 3x3 stride-1 convs (a row from each side that has a neighbour),
    # 7 downsamples (two rows from above), 3 pools (as far as the coarse
    # grid reaches).
    assert rows["t64"] == [19 + 3, 19 + 14 + 3, 0]
    assert rows["u96"] == [19 + 3, 19 + 14 + 3 * 2]
    assert rows["t96"] == [19 + 3 * 2, 2 * 19 + 14 + 3 * 2,
                           19 + 14 + 3 * 2]
