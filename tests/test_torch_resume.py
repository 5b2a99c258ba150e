"""The trainer's state across the two packages: a checkpoint written by
either ``Trainer`` restores in the other with its Adam moments, counts and
learning rate kept, for each of the three optimizer layouts (optax
``inject_hyperparams(adam)``, ``adam(schedule)`` and ``fused_adam``); a
restored port trainer steps bit for bit as the uninterrupted one does; and
the migration gate reinitializes the moments where the layout does not
match.  ``fit(resume_dir=...)`` is tested with the callbacks
(tests/test_torch_callbacks.py).

The cross-package cases run on small trees with the model's structure, and
their optimizer states come from optax ``update`` calls on seeded
gradients (no JAX train step is compiled).  After a restore, one more Adam
update agrees within 1e-6 absolute: the moments are equal, and the two
updates differ only in the order of a few float32 operations.
"""

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_parity import (IMG, SHALLOW, conv_leaves, small_tree,
                           torch_params, train_batch)
from yolov4tpu import train as jtrain
from yolov4tpu.config import YoloConfig as JaxConfig
from yolov4tpu_torch import train as ttrain
from yolov4tpu_torch.config import YoloConfig
from yolov4tpu_torch.models.network import params_from_jax, params_to_jax

C = 3
KW = dict(img_size=(IMG, IMG, 3), batch_size=2, csp_repeats=SHALLOW)
LAYOUTS = ("inject", "schedule", "fused")
LR = 3e-4          # a learning rate set between steps (layout "inject")


def _grads(params, seed):
    """Seeded gradients shaped like ``params`` (JAX layout)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: rng.normal(0, 1, p.shape).astype(np.float32), params)


def _port_grads(trainer, grads):
    """``grads`` (JAX layout) as the list of the trainer's leaves."""
    g = params_from_jax(grads, {"bn": []})[0]
    return ttrain.leaves(ttrain.tree_map(lambda _, x: x, trainer.params, g))


def _schedule(module):
    return module.cosine_annealing_schedule(1e-3, 1e-5, 4, 1)


def _port_trainer(layout, params, state):
    cfg = YoloConfig(**KW, fused_optimizer=layout == "fused")
    sched = _schedule(ttrain) if layout == "schedule" else None
    tp, ts = params_from_jax(params, state)
    return ttrain.Trainer(cfg, C, tp, ts, schedule=sched, device="cpu")


def _jax_trainer(layout, params, state):
    cfg = JaxConfig(**KW, fused_optimizer=layout == "fused")
    sched = _schedule(jtrain) if layout == "schedule" else None
    return jtrain.Trainer(cfg, C, params, state, schedule=sched)


def _jax_moments(layout, opt_state, params):
    """(count, mu tree, nu tree, learning rate or None) of a JAX opt_state,
    read from its named fields."""
    if layout == "fused":
        _, unravel = jax.flatten_util.ravel_pytree(params)
        return (int(opt_state["count"]), unravel(opt_state["mu"]),
                unravel(opt_state["nu"]), None)
    if layout == "inject":
        adam = opt_state.inner_state[0]
        lr = float(opt_state.hyperparams["learning_rate"])
    else:
        adam, lr = opt_state[0], None
    return int(adam.count), adam.mu, adam.nu, lr


def _port_moments(trainer):
    """The same four of a port trainer, moments as JAX-layout trees built
    from the port's own tensors (kernels OIHW -> HWIO)."""
    opt, params = trainer.optimizer, trainer.params
    tensors = ttrain.leaves(params)
    if isinstance(opt, ttrain.FusedAdam):
        def split(flat):
            parts, offset = [], 0
            for t in tensors:
                parts.append(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            return ttrain.unflatten(params, parts)
        mu, nu, lr = split(opt.mu), split(opt.nu), None
    else:
        state = opt.opt.state
        mu = ttrain.unflatten(params, [state[t]["exp_avg"] for t in tensors])
        nu = ttrain.unflatten(params,
                              [state[t]["exp_avg_sq"] for t in tensors])
        for t in tensors:
            assert float(state[t]["step"]) == opt.count
        lr = trainer.learning_rate if opt.schedule is None else None
    return opt.count, mu, nu, lr


def _assert_moments_equal(port, jax_side):
    pc, pmu, pnu, plr = port
    jc, jmu, jnu, jlr = jax_side
    assert pc == jc
    assert plr == jlr
    for p_tree, j_tree in ((pmu, jmu), (pnu, jnu)):
        got, want = conv_leaves(p_tree), conv_leaves(j_tree)
        assert [(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in want]
        for (_, _, g), (_, _, w) in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


def _assert_update_agrees(trainer, jt, grads):
    """One more Adam update from the same gradients on both sides."""
    upd, _ = jt.optimizer.update(grads, jt.opt_state, jt.params)
    want = optax.apply_updates(jt.params, upd)
    trainer.optimizer.step(_port_grads(trainer, grads))
    got = params_to_jax(trainer.params, trainer.state)[0]
    for (_, _, g), (_, _, w) in zip(conv_leaves(got), conv_leaves(want)):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=1e-6)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_port_checkpoint_restores_in_jax(layout, tmp_path, capsys):
    params, state = small_tree()
    trainer = _port_trainer(layout, params, state)
    for seed in (1, 2):
        trainer.optimizer.step(_port_grads(trainer, _grads(params, seed)))
        if layout == "inject":
            trainer.set_learning_rate(LR)
    trainer.global_step = 2
    path = str(tmp_path / "port.npz")
    trainer.save_checkpoint(path, epoch=4)

    jt = _jax_trainer(layout, *small_tree(9))
    capsys.readouterr()
    assert jt.restore_checkpoint(path) == 5
    assert "reinitializing" not in capsys.readouterr().out
    assert jt.global_step == 2
    _assert_moments_equal(_port_moments(trainer),
                          _jax_moments(layout, jt.opt_state, jt.params))
    want = params_to_jax(trainer.params, trainer.state)
    for (_, _, g), (_, _, w) in zip(conv_leaves(jt.params),
                                    conv_leaves(want[0])):
        np.testing.assert_array_equal(np.asarray(g), w)
    _assert_update_agrees(trainer, jt, _grads(params, 3))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_jax_checkpoint_restores_in_the_port(layout, tmp_path, capsys):
    params, state = small_tree()
    jt = _jax_trainer(layout, params, state)
    p, opt_state = params, jt.opt_state
    for seed in (1, 2):
        upd, opt_state = jt.optimizer.update(_grads(params, seed), opt_state,
                                             p)
        p = optax.apply_updates(p, upd)
        if layout == "inject":
            opt_state.hyperparams["learning_rate"] = jnp.float32(LR)
    jt.params, jt.opt_state, jt.global_step = p, opt_state, 2
    path = str(tmp_path / "jax.npz")
    jt.save_checkpoint(path, epoch=4)

    trainer = _port_trainer(layout, *small_tree(9))
    capsys.readouterr()
    assert trainer.restore_checkpoint(path) == 5
    assert "reinitializing" not in capsys.readouterr().out
    assert trainer.global_step == 2
    _assert_moments_equal(_port_moments(trainer),
                          _jax_moments(layout, jt.opt_state, jt.params))
    if layout == "inject":
        assert trainer.learning_rate == float(np.float32(LR))
    got = params_to_jax(trainer.params, trainer.state)
    for (_, _, g), (_, _, w) in zip(conv_leaves(got[0]), conv_leaves(p)):
        np.testing.assert_array_equal(g, np.asarray(w))
    for g, w in zip(got[1]["bn"], state["bn"]):
        assert (g is None) == (w is None)
    # The parameters were written into the tensors the optimizer holds.
    tensors = ttrain.leaves(trainer.params)
    assert all(a is b for a, b in zip(trainer.optimizer.tensors, tensors))
    _assert_update_agrees(trainer, jt, _grads(params, 3))


# --- the port on its own, on the shallow model --------------------------------

def _state_of(trainer):
    """Everything a step reads: params, BN state, moments, count, LR."""
    opt = trainer.optimizer
    moments = [opt.opt.state[t][k] for t in opt.tensors
               for k in ("exp_avg", "exp_avg_sq", "step")]
    return (ttrain.leaves(trainer.params) + ttrain.leaves(trainer.state)
            + moments, (opt.count, trainer.learning_rate, trainer.global_step))


def test_restored_trainer_steps_bit_equal(tmp_path):
    """A fresh trainer restored from a checkpoint holds exactly the state
    of the trainer that wrote it, and its next step is bit-equal to the
    uninterrupted trainer's."""
    a = ttrain.Trainer(YoloConfig(**KW), C, *torch_params(C), device="cpu")
    grads = [torch.randn(t.shape, generator=torch.Generator().manual_seed(i))
             for i, t in enumerate(ttrain.leaves(a.params))]
    a.optimizer.step(grads)
    a.global_step = 1
    a.set_learning_rate(LR)
    path = str(tmp_path / "latest.npz")
    a.save_checkpoint(path, epoch=0)
    b = ttrain.Trainer(YoloConfig(**KW), C, *torch_params(C), device="cpu")
    assert b.restore_checkpoint(path) == 1
    batch = train_batch(1, 2, C)[0]
    for stepped in (False, True):
        (ta, sa), (tb, sb) = _state_of(a), _state_of(b)
        assert sa == sb
        assert len(ta) == len(tb)
        for x, y in zip(ta, tb):
            assert torch.equal(x, y)
        if not stepped:
            la, lb = a.train_step(batch)["loss"], b.train_step(batch)["loss"]
            assert float(la) == float(lb)
    assert all(x is y for x, y in zip(b.optimizer.tensors,
                                       ttrain.leaves(b.params)))


# --- the migration gate (mirrors tests/test_train.py's two cases) ------------

def test_restore_migrates_another_optimizer_layout(tmp_path, capsys):
    """A checkpoint of another optimizer layout (here the scheduled Adam's)
    restores params, step and epoch, and reinitializes the moments."""
    params, state = small_tree()
    old = _port_trainer("schedule", params, state)
    old.optimizer.step(_port_grads(old, _grads(params, 1)))
    old.global_step = 7
    path = str(tmp_path / "old.npz")
    old.save_checkpoint(path, epoch=3)

    new = _port_trainer("inject", *small_tree(9))
    new.optimizer.step(_port_grads(new, _grads(params, 2)))
    new.set_learning_rate(LR)
    capsys.readouterr()
    assert new.restore_checkpoint(path) == 4
    assert "reinitializing optimizer state" in capsys.readouterr().out
    assert new.global_step == 7
    for a, b in zip(ttrain.leaves(new.params), ttrain.leaves(old.params)):
        assert torch.equal(a, b)
    assert new.optimizer.count == 0 and not new.optimizer.opt.state
    assert new.learning_rate == pytest.approx(YoloConfig(**KW).learning_rate)


@pytest.mark.parametrize("layout", ["inject", "fused"])
def test_restore_rejects_same_count_different_shape(layout, tmp_path,
                                                    capsys):
    """The gate checks each leaf's shape and dtype, not only the count: a
    file with one moment raveled (same leaf count) reinitializes."""
    params, state = small_tree()
    trainer = _port_trainer(layout, params, state)
    trainer.optimizer.step(_port_grads(trainer, _grads(params, 1)))
    path = str(tmp_path / "ck.npz")
    trainer.save_checkpoint(path, epoch=1)
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    key = next(k for k in sorted(flat) if k.startswith("state/opt_leaves/")
               and flat[k].ndim >= (2 if layout == "inject" else 1))
    flat[key] = (flat[key].ravel() if layout == "inject"
                 else flat[key][:-1])
    tampered = str(tmp_path / "tampered.npz")
    np.savez(tampered, **flat)

    fresh = _port_trainer(layout, *small_tree(9))
    capsys.readouterr()
    assert fresh.restore_checkpoint(tampered) == 2
    assert "reinitializing optimizer state" in capsys.readouterr().out
    assert fresh.optimizer.count == 0
    # the JAX Trainer refuses the same file the same way
    jt = _jax_trainer(layout, params, state)
    assert jt.restore_checkpoint(tampered) == 2
    assert "reinitializing optimizer state" in capsys.readouterr().out


def test_restore_refuses_another_model(tmp_path):
    params, state = small_tree()
    trainer = _port_trainer("inject", params, state)
    path = str(tmp_path / "ck.npz")
    trainer.save_checkpoint(path)
    small = {"convs": params["convs"][:2]}, {"bn": state["bn"][:2]}
    with pytest.raises(ValueError, match="do not fit"):
        _port_trainer("inject", *small).restore_checkpoint(path)
    wide = jax.tree.map(lambda a: np.concatenate([a, a], axis=-1), params)
    with pytest.raises(ValueError, match="where this Trainer's model has"):
        _port_trainer("inject", wide, state).restore_checkpoint(path)
