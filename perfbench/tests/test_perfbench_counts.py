"""The frozen work counts of the yardstick."""

import numpy as np
import pytest

from perfbench.harness import counts, peaks
from perfbench.reference import nms, topology


@pytest.mark.parametrize("side, darknet_gflop", [(416, 60.1), (608, 128.5)])
def test_model_flops_match_darknet(side, darknet_gflop):
    gflop = counts.model_flops(side) / 1e9
    assert len(topology.conv_layers(side)) == 110
    assert abs(gflop - darknet_gflop) / darknet_gflop < 1e-3
    assert round(gflop, 3) == {416: 60.105, 608: 128.389}[side]


def test_wgrad_shapes_match_the_program():
    from yolov4tpu_torch.tools.measure import wgrad_shapes
    mine = counts.wgrad_shapes(608)
    assert sum(mine.values()) == 37
    assert dict(mine) == dict(wgrad_shapes(608))


def test_wgrad_least_time_is_operation_bound_at_608():
    t = counts.wgrad_least_s(32, 608)
    ops = sum(n * 2 * 9 * 32 * h * h * ci * co
              for (h, ci, co), n in counts.wgrad_shapes(608).items())
    assert t >= ops / peaks.BF16_FLOPS
    # 608^2 b8 per the smoke script's bound, 0.7664 ms, times 4.
    assert abs(t - 4 * 0.7664e-3) / (4 * 0.7664e-3) < 0.01


def _candidates(seed, k=64, c=5):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0.2, 0.8, (k, 2))
    wh = rng.uniform(0.05, 0.3, (k, 2))
    return (np.concatenate([xy - wh / 2, xy + wh / 2], 1),
            rng.uniform(0, 1, (k, c)))


@pytest.mark.parametrize("seed", [0, 1])
def test_nms_work_depends_on_the_candidates_only(seed):
    boxes, scores = _candidates(seed)
    kept, tests = nms.greedy(boxes, scores, 0.413, 0.3)
    perm = np.random.default_rng(seed + 9).permutation(len(boxes))
    kept2, tests2 = nms.greedy(boxes[perm], scores[perm], 0.413, 0.3)
    assert tests == tests2 and len(kept) == len(kept2)
    assert {(int(perm[a]), c) for a, c in kept2} == set(kept)
    # Classes laid out in another order: the same work.
    cperm = np.arange(scores.shape[1])[::-1]
    assert nms.greedy(boxes, scores[:, cperm], 0.413, 0.3)[1] == tests
    # Each kept box tests every lower box of its class still alive, so the
    # count lies between the kept pairs' and the all-pairs bound.
    n = (scores > 0.3).sum(0)
    assert len(kept) - scores.shape[1] <= tests <= int(
        sum(v * (v - 1) // 2 for v in n))
    least = counts.nms_least_s({"bytes": 64 * 25, "tests": tests})
    assert least == max(64 * 25 / peaks.HBM_BYTES_PER_S,
                        tests * peaks.IOU_OPS / peaks.F32_FLOPS)


def test_greedy_equals_the_programs_exact_nms():
    import torch
    from yolov4tpu_torch.ops.nms import combined_nms
    for seed in range(3):
        boxes, scores = _candidates(seed)
        kept, _ = nms.greedy(boxes, scores, 0.413, 0.3)
        _, s, _, n = combined_nms(
            torch.tensor(boxes[None], dtype=torch.float64),
            torch.tensor(scores[None]), 0.413, 0.3, 100, 100, 256,
            clip=False)
        mine = sorted(scores[a, k] for a, k in kept)[::-1][:100]
        theirs = s[0, :int(n[0])].numpy()
        assert np.allclose(mine, theirs)
