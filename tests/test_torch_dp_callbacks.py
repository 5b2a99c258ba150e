"""Work that rank 0 alone does between data-parallel steps
(``parallel.on_rank0``), on two gloo ranks (``tests/_torch_dp_worker.py``):
``EvalMapCallback`` over a stand-in for the facade, on a mesh whose steps
run over a group with a collective timeout of 3 s.

  - rank 0's evaluation takes 6 s, twice that timeout: rank 1 waits for
    it, then both take a step; no collective times out, and the ranks end
    bit-equal;
  - rank 0's next evaluation raises: rank 1 raises too, and both go on to
    take another step together.
"""

import numpy as np
import pytest

from _torch_parity import (IMG, SHALLOW, DPWorkers, dp_leaves,
                           remove_at_teardown, torch_params, train_batch)

C = 3
KW = dict(img_size=[IMG, IMG, 3], batch_size=2, csp_repeats=list(SHALLOW),
          learning_rate=1e-3)
TIMEOUT, SLEEP = 3.0, 6.0


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    spec = {"num_classes": C, "scenarios": [
        {"name": "eval", "kind": "rank0_eval", "config": KW, "batch": "b4",
         "timeout": TIMEOUT, "sleep": SLEEP}]}
    work = tmp_path_factory.mktemp("dp_callbacks")
    yield DPWorkers(work, spec, *torch_params(C),
                    {"b4": train_batch(31, 4, C)[0]}).results()
    remove_at_teardown(request, work)


def _assert_ranks_equal(r0, r1, name):
    loss = f"{name}/metrics/loss"
    assert float(r0[loss]) == float(r1[loss])
    for kind in ("params", "state"):
        for a, b in zip(dp_leaves(r0, name, kind), dp_leaves(r1, name, kind)):
            np.testing.assert_array_equal(a, b)


def test_rank0_evaluation_outlasts_the_collective_timeout(run):
    r0, r1 = run
    assert "eval/error0" not in r0 and "eval/error0" not in r1
    assert int(r0["eval/evaluations0"]) == 1
    assert int(r1["eval/evaluations0"]) == 0
    assert float(r1["eval/waited0"]) >= SLEEP - 1.0 > TIMEOUT
    for r in (r0, r1):
        assert int(r["eval0/slab"]) == 1
        assert np.isfinite(float(r["eval0/metrics/loss"]))
    _assert_ranks_equal(r0, r1, "eval0")


def test_rank0_failure_raises_on_every_rank(run):
    r0, r1 = run
    assert str(r0["eval/error1"]) == "ValueError: the evaluation failed"
    assert str(r1["eval/error1"]).startswith("RuntimeError: rank 0 failed")
    _assert_ranks_equal(r0, r1, "eval1")
