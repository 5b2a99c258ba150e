"""Ragged global batches on two gloo ranks (``tests/_torch_dp_worker.py``),
through ``Trainer.train_step`` / ``eval_step`` on a mesh, with SGD so the
update is linear in the gradients (as tests/test_train.py's masked mesh
test does):

  - 3 samples pad to 4: rank 0 holds 2 valid rows, rank 1 one valid row
    and one pad, so the masked step weighs the ranks (2, 1).  Held to the
    hand-computed combination, the port's gradient core on each rank's
    masked rows combined by ``_torch_parity.slab_mean`` with weights
    (2, 1), then the SGD step: bit-equal (the same float32 operations in
    the same order), and the uniform (1, 1) combination must differ by
    more than 1e-3 of a leaf's update;
  - 1 sample pads to 2: rank 1 holds only padding (weight 0) and every
    result stays finite; the same hand-computed check with (1, 0);
  - the masked ``eval_step`` of the 3 samples against the JAX package's
    ``make_eval_step(mesh=make_mesh(2), masked=True)`` on the same padded
    batch (BN in inference mode, so float32 holds it to rel 1e-5).

The JAX eval step compiles while the workers and the emulation run.
"""

import numpy as np
import pytest

from _torch_parity import (IMG, SHALLOW, DPWorkers, background,
                           dp_emulation, dp_leaves, remove_at_teardown,
                           to_torch, torch_params, train_batch,
                           well_conditioned)
from _torch_dp_worker import SGD
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig

C = 3
KW = dict(img_size=[IMG, IMG, 3], batch_size=2, csp_repeats=list(SHALLOW),
          learning_rate=1e-3)


def _cfg(cls):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in KW.items()})


def _emulate(batches):
    """(params, state, metrics) of the hand-computed combination for each
    case, and the uniformly weighted one for the 3-sample batch."""
    tp, ts = torch_params(C)
    cfg = _cfg(YoloConfig)
    core = ttrain._make_grad_and_metrics(C, cfg)
    out = {}
    for name, n, weights in (("w21", 4, (2, 1)), ("w11", 4, (1, 1)),
                             ("tail1", 2, (1, 0))):
        b = batches["b3" if n == 4 else "b1"]
        padded = ttrain.pad_mask_batch(to_torch(b), n)
        k = n // 2
        shards = [ttrain.tree_map(lambda x: x[r * k:(r + 1) * k], padded)
                  for r in range(2)]
        out[name] = dp_emulation(core, tp, ts, shards, weights,
                                 lambda t: SGD(t, cfg.learning_rate))
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    params, state = well_conditioned(C)
    batches = {"b3": train_batch(21, 3, C)[0], "b1": train_batch(22, 1, C)[0]}
    # Heterogeneous samples, so a mis-weighted combination cannot pass by
    # symmetry.
    batches["b3"]["image"][2] *= 0.3
    spec = {"num_classes": C, "scenarios": [
        {"name": "w21", "kind": "trainer", "config": KW, "optimizer": "sgd",
         "batches": ["b3"]},
        {"name": "tail1", "kind": "trainer", "config": KW,
         "optimizer": "sgd", "batches": ["b1"]},
        {"name": "eval", "kind": "trainer", "config": KW, "eval": ["b3"]}]}
    work = tmp_path_factory.mktemp("dp_ragged")
    workers = DPWorkers(work, spec, *torch_params(C), batches)
    emulated = background(_emulate, batches)
    step = jtrain.make_eval_step(C, _cfg(JaxConfig), mesh=jax_make_mesh(2),
                                 masked=True)
    loss_j = float(step(params, state, jtrain.pad_mask_batch(batches["b3"],
                                                             4)))
    yield emulated(), workers.results(), loss_j
    remove_at_teardown(request, work)


def _assert_equal(out, name, want):
    p, s, m = want
    for got, w in zip(dp_leaves(out, name, "params"), ttrain.leaves(p)):
        np.testing.assert_array_equal(got, w.numpy())
    for got, w in zip(dp_leaves(out, name, "state"), ttrain.leaves(s)):
        np.testing.assert_array_equal(got, w.numpy())
    assert float(out[f"{name}/metrics/loss"]) == float(m["loss"])


def test_weighted_two_to_one_equals_the_hand_computed_step(run):
    emulated, (r0, r1), _ = run
    _assert_equal(r0, "w21", emulated["w21"])
    _assert_equal(r1, "w21", emulated["w21"])
    for r in (r0, r1):
        assert int(r["w21/all_reduce"]) == 1
        assert int(r["w21/slab"]) == 1
    # The uniform combination moves some leaf by more than 1e-3 of its
    # largest entry's distance from the start.
    start = ttrain.leaves(torch_params(C)[0])
    uniform = ttrain.leaves(emulated["w11"][0])
    assert max(float(np.abs(a - u.numpy()).max())
               / max(float(np.abs(a - s0.numpy()).max()), 1e-30)
               for a, u, s0 in zip(dp_leaves(r0, "w21", "params"), uniform,
                                   start)) > 1e-3


def test_all_padding_rank_contributes_nothing_and_stays_finite(run):
    emulated, (r0, r1), _ = run
    for r in (r0, r1):
        for kind in ("params", "state"):
            assert all(np.isfinite(a).all() for a in dp_leaves(r, "tail1",
                                                                kind))
        assert np.isfinite(float(r["tail1/metrics/loss"]))
        assert int(r["tail1/all_reduce"]) == 1
        _assert_equal(r, "tail1", emulated["tail1"])


def test_masked_eval_matches_jax(run):
    _, (r0, r1), loss_j = run
    loss_t = float(r0["eval/metrics/eval0"])
    assert float(r1["eval/metrics/eval0"]) == loss_t
    assert int(r0["eval/all_reduce"]) == 1
    assert loss_t == pytest.approx(loss_j, rel=1e-5)
