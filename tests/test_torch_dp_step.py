"""The port's data-parallel train step, ``train.make_train_step(mesh=)``,
on two gloo ranks in two processes (``tests/_torch_dp_worker.py``), one
Adam step on a 4-sample global batch (2 rows a rank):

  - both ranks end bit-equal;
  - each step makes exactly one ``torch.distributed.all_reduce``;
  - rank 0 equals the step emulated in this process bit for bit: the
    port's gradient core on each rank's rows, combined by
    ``_torch_parity.slab_mean``, then one Adam step (the same float32
    operations in the same order; gloo's sum of two buffers is a + b,
    which is b + a);
  - against the JAX package's ``make_train_step(mesh=make_mesh(2))`` on
    the same numpy inputs, with tests/test_torch_train_step.py's
    tolerances (the float32 training forward is chaotic at this size):
    loss rel 1e-5 plus twice the JAX step's own movement under a 1e-6
    relative perturbation of the images, BN moving statistics 1e-4
    absolute, and the Adam step agreement of
    ``_torch_parity.adam_step_agreement``.

The JAX step is traced while the workers run, and compiled and run while a
thread emulates the step.
"""

import jax
import numpy as np
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, DPWorkers, adam_step_agreement,
                           background, dp_emulation, dp_leaves,
                           remove_at_teardown, to_torch, torch_params,
                           train_batch, well_conditioned)
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


def _perturbed(batch, eps=1e-6, seed=1):
    rng = np.random.default_rng(seed)
    img = batch["image"] * (1 + eps * rng.normal(size=batch["image"].shape))
    return dict(batch, image=img.astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    params, state = well_conditioned(C)
    batch, _ = train_batch(11, 4, C)
    spec = {"num_classes": C, "scenarios": [
        {"name": "plain", "kind": "step", "config": KW, "batch": "b4"}]}
    work = tmp_path_factory.mktemp("dp_step")
    started = background(DPWorkers, work, spec, *torch_params(C),
                         {"b4": batch})
    jcfg = _cfg(JaxConfig)
    opt = jtrain.make_optimizer(jcfg)
    step = jtrain.make_train_step(C, jcfg, opt, mesh=jax_make_mesh(2),
                                  donate=False)
    # Tracing is Python; the emulation's op dispatch would contend with it
    # for the interpreter, so the emulation starts once the trace is done.
    lowered = step.lower(params, state, opt.init(params), batch)
    workers = started()
    emulated = background(_emulate, batch)
    compiled = lowered.compile()
    p_j, s_j, _, m_j = compiled(params, state, opt.init(params), batch)
    _, _, _, m_p = compiled(params, state, opt.init(params),
                            _perturbed(batch))
    jax_out = jax.tree.map(np.asarray, (p_j, s_j, m_j, m_p))
    yield emulated(), workers.results(), jax_out
    remove_at_teardown(request, work)


def _emulate(batch):
    tp, ts = torch_params(C)
    cfg = _cfg(YoloConfig)
    core = ttrain._make_grad_and_metrics(C, cfg)
    full = to_torch(batch)
    shards = [ttrain.tree_map(lambda x: x[2 * r:2 * r + 2], full)
              for r in range(2)]
    return dp_emulation(core, tp, ts, shards, [2, 2],
                        lambda t: ttrain.make_optimizer(cfg, t))


def test_ranks_are_bit_equal(run):
    _, (r0, r1), _ = run
    def keys(out):
        return sorted(k for k in out
                      if k.startswith("plain/") and k != "plain/seconds")

    assert keys(r0) and keys(r0) == keys(r1)
    for k in keys(r0):
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_one_all_reduce_per_step(run):
    for out in run[1]:
        assert int(out["plain/all_reduce"]) == 1
        assert int(out["plain/slab"]) == 1


def test_equals_the_emulation(run):
    (p, s, m), (r0, _), _ = run
    for got, want in zip(dp_leaves(r0, "plain", "params"), ttrain.leaves(p)):
        np.testing.assert_array_equal(got, want.numpy())
    for got, want in zip(dp_leaves(r0, "plain", "state"), ttrain.leaves(s)):
        np.testing.assert_array_equal(got, want.numpy())
    for k, v in m.items():
        assert float(r0[f"plain/metrics/{k}"]) == float(v), k


def test_matches_the_jax_mesh_step(run):
    _, (r0, _), (p_j, s_j, m_j, m_p) = run
    loss_j, loss_t = float(m_j["loss"]), float(r0["plain/metrics/loss"])
    moved = abs(float(m_p["loss"]) - loss_j) / loss_j
    assert abs(loss_t - loss_j) / loss_j <= 1e-5 + 2 * moved
    tp, ts = torch_params(C)
    state_t = ttrain.unflatten(ts, [torch.from_numpy(a) for a in
                                    dp_leaves(r0, "plain", "state")])
    for a, b in zip(state_t["bn"], s_j["bn"]):
        if b is not None:
            for k in ("mean", "var"):
                np.testing.assert_allclose(a[k].numpy(), b[k], rtol=0,
                                           atol=1e-4)
    params_t = ttrain.unflatten(tp, [torch.from_numpy(a) for a in
                                     dp_leaves(r0, "plain", "params")])
    frac, worst = adam_step_agreement(tp, p_j, params_t, KW["learning_rate"])
    assert frac >= 0.9, frac
    assert worst <= 2.0 + 1e-3, worst
