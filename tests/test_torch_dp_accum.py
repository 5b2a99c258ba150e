"""Gradient accumulation and the two-phase step on two gloo ranks
(``tests/_torch_dp_worker.py``):

  - ``grad_accum_steps=2`` on a ragged 3 samples, padded to 4 (each rank
    two micro-batches of one; rank 1's second is all padding, which must
    leave its BN statistics as they were), equal bit for bit to the
    emulation in this process: the port's accumulated core on each rank's
    (2, 1) stack, combined by ``slab_mean`` with the ranks' valid counts
    (2, 1), then one Adam step;
  - ``make_train_step_twophase`` bit-equal to the fused mesh step, and its
    refusal of accumulation.

No JAX program: tests/test_torch_train_ragged.py holds the port's
accumulation to the JAX package's.
"""

import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, DPWorkers, background,
                           dp_emulation, dp_leaves, remove_at_teardown,
                           to_torch, torch_params, train_batch)
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.parallel import Mesh

C = 3
KW = dict(img_size=[IMG, IMG, 3], batch_size=2, csp_repeats=list(SHALLOW),
          learning_rate=1e-3)
ACCUM = dict(KW, grad_accum_steps=2)


def _cfg(kw):
    return YoloConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in kw.items()})


def _emulate(batches):
    tp, ts = torch_params(C)
    cfg = _cfg(ACCUM)
    core = ttrain._accumulated(ttrain._make_grad_and_metrics(C, cfg), 2)
    stacked = ttrain.chunk_batch(
        ttrain.pad_mask_batch(to_torch(batches["b3"]), 4), 2)
    shards = [ttrain.tree_map(lambda x: x[:, r:r + 1], stacked)
              for r in range(2)]
    assert [float(s["mask"].sum()) for s in shards] == [2.0, 1.0]
    return dp_emulation(core, tp, ts, shards, [2, 1],
                        lambda t: ttrain.make_optimizer(cfg, t))


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    params, state = torch_params(C)
    batches = {"b4": train_batch(41, 4, C)[0], "b3": train_batch(42, 3, C)[0]}
    spec = {"num_classes": C, "scenarios": [
        {"name": "accum3", "kind": "trainer", "config": ACCUM,
         "batches": ["b3"]},
        {"name": "fused", "kind": "step", "config": KW, "batch": "b4"},
        {"name": "twophase", "kind": "twophase", "config": KW,
         "batch": "b4"}]}
    work = tmp_path_factory.mktemp("dp_accum")
    workers = DPWorkers(work, spec, params, state, batches)
    emulated = background(_emulate, batches)
    yield emulated(), workers.results()
    remove_at_teardown(request, work)


def _assert_equal(out, name, want):
    p, s, m = want
    for got, w in zip(dp_leaves(out, name, "params"), ttrain.leaves(p)):
        np.testing.assert_array_equal(got, w.numpy())
    for got, w in zip(dp_leaves(out, name, "state"), ttrain.leaves(s)):
        np.testing.assert_array_equal(got, w.numpy())
    assert float(out[f"{name}/metrics/loss"]) == float(m["loss"])


def test_accumulation_equals_the_emulation(run):
    emulated, outs = run
    for out in outs:
        _assert_equal(out, "accum3", emulated)
        assert int(out["accum3/all_reduce"]) == 1


def test_all_padding_micro_batch_keeps_the_rank_bn_state():
    """Rank 1's second micro-batch of the padded 3 holds only padding: its
    accumulated core returns the BN state of its first micro-batch."""
    tp, ts = torch_params(C)
    cfg = _cfg(ACCUM)
    stacked = ttrain.chunk_batch(ttrain.pad_mask_batch(
        to_torch(train_batch(42, 3, C)[0]), 4), 2)
    rank1 = ttrain.tree_map(lambda x: x[:, 1:2], stacked)
    assert rank1["mask"].tolist() == [[1.0], [0.0]]
    core = ttrain._make_grad_and_metrics(C, cfg)
    _, st_first, _ = core(tp, ts, ttrain.tree_map(lambda x: x[0], rank1))
    _, st, _ = ttrain._accumulated(core, 2)(tp, ts, rank1)
    for a, b in zip(ttrain.leaves(st), ttrain.leaves(st_first)):
        assert torch.equal(a, b)


def test_twophase_is_bit_equal_to_the_fused_step(run):
    for out in run[1]:
        for kind in ("params", "state"):
            for a, b in zip(dp_leaves(out, "fused", kind),
                            dp_leaves(out, "twophase", kind)):
                np.testing.assert_array_equal(a, b)
        assert int(out["twophase/all_reduce"]) == 1


def test_twophase_refuses_accumulation():
    tp, _ = torch_params(C)
    cfg = _cfg(ACCUM)
    opt = ttrain.make_optimizer(cfg, ttrain.leaves(tp))
    mesh = Mesh(rank=0, size=2, device=torch.device("cpu"))
    with pytest.raises(ValueError, match="twophase"):
        ttrain.make_train_step_twophase(C, cfg, opt, mesh)
