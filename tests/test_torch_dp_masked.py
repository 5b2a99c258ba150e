"""The port's masked data-parallel step against the JAX package's
``make_train_step(mesh=make_mesh(2), masked=True)``: ragged global batches
through ``Trainer.train_step`` on two gloo ranks
(``tests/_torch_dp_worker.py``), with SGD on both sides so the update is
linear in the gradients (as tests/test_train.py's masked mesh test does):

  - 3 samples: both sides pad to 4, rank 0 holds 2 valid rows and rank 1
    one valid row and one pad, weighted (2, 1);
  - 1 sample: rank 1 holds only padding, weighted (1, 0).  The port pads
    to 2 rows (one a rank); the JAX step runs at its one compiled shape of
    4 rows (rank 0 one valid row and one pad, rank 1 two pads), which
    weighs the ranks the same and gives the same result: padded rows drop
    out of the loss and of BatchNorm's moments.

Tolerances follow tests/test_torch_train_step.py (the float32 training
forward is chaotic at this size): a fixed tolerance plus twice the JAX
step's own movement under a 1e-6 relative perturbation of the images.  The
loss: rel 1e-5 plus that; each parameter leaf's update: rel-RMS 1e-4 plus
that.  The BN moving statistics: 1e-4 absolute plus that, per BatchNorm
(that file holds them to 1e-4 alone at 2 samples; here a rank's moments
run over one or two valid samples, and the perturbation alone moves the
deepest layers' variances by up to 1e-3).

The JAX step compiles while the workers run.
"""

import jax
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, DPWorkers, conv_leaves, dp_leaves,
                           rel_rms, remove_at_teardown, torch_params,
                           train_batch, well_conditioned)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu.parallel.mesh import make_mesh as jax_make_mesh
from yolov4tpu_torch import train as ttrain

C = 3
KW = dict(img_size=[IMG, IMG, 3], batch_size=2, csp_repeats=list(SHALLOW),
          learning_rate=0.1)
CASES = {"w21": "b3", "tail1": "b1"}


def _perturbed(batch, eps=1e-6, seed=1):
    rng = np.random.default_rng(seed)
    img = batch["image"] * (1 + eps * rng.normal(size=batch["image"].shape))
    return dict(batch, image=img.astype(np.float32))


@pytest.fixture(scope="module")
def run(tmp_path_factory, request):
    params, state = well_conditioned(C)
    batches = {"b3": train_batch(21, 3, C)[0], "b1": train_batch(22, 1, C)[0]}
    # Heterogeneous samples, so a mis-weighted combination cannot pass by
    # symmetry.
    batches["b3"]["image"][2] *= 0.3
    spec = {"num_classes": C, "scenarios": [
        {"name": name, "kind": "trainer", "config": KW, "optimizer": "sgd",
         "batches": [b]} for name, b in CASES.items()]}
    work = tmp_path_factory.mktemp("dp_masked")
    workers = DPWorkers(work, spec, *torch_params(C), batches)
    jcfg = JaxConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in KW.items()})
    opt = optax.sgd(KW["learning_rate"])
    step = jtrain.make_train_step(C, jcfg, opt, mesh=jax_make_mesh(2),
                                  donate=False, masked=True)
    padded = {key: jtrain.pad_mask_batch(batch, 4) for name, b in CASES.items()
              for key, batch in ((name, batches[b]),
                                 (f"{name}_p", _perturbed(batches[b])))}
    compiled = step.lower(params, state, opt.init(params),
                          padded["w21"]).compile()
    jax_out = {}
    for key, batch in padded.items():
        p, s, _, m = compiled(params, state, opt.init(params), batch)
        jax_out[key] = jax.tree.map(np.asarray, (p, s, m))
    yield workers.results(), jax_out
    remove_at_teardown(request, work)


@pytest.mark.parametrize("name", list(CASES))
def test_masked_step_matches_the_jax_mesh_step(run, name):
    (r0, r1), jax_out = run
    (p_j, s_j, m_j), (p_p, s_p, m_p) = jax_out[name], jax_out[f"{name}_p"]
    loss_j, loss_t = float(m_j["loss"]), float(r0[f"{name}/metrics/loss"])
    assert float(r1[f"{name}/metrics/loss"]) == loss_t
    moved = abs(float(m_p["loss"]) - loss_j) / loss_j
    assert abs(loss_t - loss_j) / loss_j <= 1e-5 + 2 * moved
    tp, ts = torch_params(C)
    state_t = ttrain.unflatten(ts, [torch.from_numpy(a) for a in
                                    dp_leaves(r0, name, "state")])
    for i, (a, b, c) in enumerate(zip(state_t["bn"], s_j["bn"], s_p["bn"])):
        if b is not None:
            for k in ("mean", "var"):
                err = float(np.abs(a[k].numpy() - b[k]).max())
                noise = float(np.abs(c[k] - b[k]).max())
                assert err <= 1e-4 + 2 * noise, (i, k, err, noise)
    params_t = ttrain.unflatten(tp, [torch.from_numpy(a) for a in
                                     dp_leaves(r0, name, "params")])
    start = well_conditioned(C)[0]
    for (i, k, t), (_, _, j), (_, _, p), (_, _, s) in zip(
            conv_leaves(params_t), conv_leaves(p_j), conv_leaves(p_p),
            conv_leaves(start)):
        assert np.isfinite(t).all()
        s = s.astype(np.float64)
        err, noise = rel_rms(t - s, j - s), rel_rms(p - s, j - s)
        assert err <= 1e-4 + 2 * noise, (i, k, err, noise)
