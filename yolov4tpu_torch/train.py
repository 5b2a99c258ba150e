"""Training: Adam, the train step, data-parallel steps and ``Trainer``.

Counterpart of ``yolov4tpu.train``.  The JAX package's step is a pure
function of (params, state, opt_state, batch); here the parameters are
float32 tensors on the device that the optimizer updates in place (no
second copy of the 64 M parameters), and the step returns the new BN state
and the metrics.  Parameters, state and batches are the same nested
dictionaries and lists as in the JAX package (``models.network``), with
OIHW kernels.

Data-parallel training (``parallel.mesh``) runs one process per rank.
Each rank's step computes gradients with BatchNorm statistics local to its
shard (no SyncBN, as under MirroredStrategy and the JAX package's
shard_map), then ONE all-reduce of one float32 slab (``_allreduce_slab``)
combines the gradients, the new BN state and the metrics, weighted by each
rank's valid-sample count, and every rank applies the same update.

Also: the cosine-annealing LR schedule of the reference's
CosineAnnealingScheduler (reference custom_callbacks.py:5-15), gradient
accumulation, pad-and-mask and chunked steps for ragged batches, the epoch
loop ``Trainer.fit``, and checkpoints in the JAX Trainer's file layout
(``Trainer.save_checkpoint``/``restore_checkpoint``, ``fit(resume_dir=)``):
the optimizer's state is written as optax's leaves (``optimizer_leaves``),
so a checkpoint of either package resumes in the other.
"""

from __future__ import annotations

import contextlib
import math
import time
import zlib
from typing import Callable, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .config import YoloConfig, require_yolov4
from .device import resolve_device, to_device_async
from .losses import yolo_loss
from .models import network
from .ops import bn_act
from .ops import build as kbuild
from .parallel.mesh import make_mesh, on_rank0, replicate, shard_batch
from .utils.profiling import span


# ---------------------------------------------------------------------------
# Nested dictionaries and lists of tensors (the JAX package's pytrees)
# ---------------------------------------------------------------------------

def tree_map(fn, tree, *rest):
    """fn over the leaves of ``tree`` (and the matching leaves of ``rest``);
    None entries (convs without BN) stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def leaves(tree) -> list:
    """The leaves of ``tree`` in order (dict insertion order)."""
    out = []
    tree_map(out.append, tree)
    return out


def unflatten(tree, values):
    """``tree`` with its leaves replaced, in order, by ``values``."""
    it = iter(values)
    return tree_map(lambda _: next(it), tree)


def _batch_size(batch) -> int:
    return leaves(batch)[0].shape[0]


# ---------------------------------------------------------------------------
# Learning rate and optimizers
# ---------------------------------------------------------------------------

def cosine_annealing_schedule(lr_max: float, lr_min: float, cycle_epochs: int,
                              steps_per_epoch: int) -> Callable[[int], float]:
    """Per-epoch cosine annealing with restarts (reference
    custom_callbacks.py:13-15):
    lr = lr_min + (lr_max - lr_min) * (1 + cos(pi * (epoch % cycle) / cycle)) / 2
    """

    def schedule(step):
        epoch = step // steps_per_epoch
        t = (epoch % cycle_epochs) / cycle_epochs
        return lr_min + (lr_max - lr_min) * (1 + math.cos(math.pi * t)) / 2

    return schedule


class Adam:
    """``torch.optim.Adam`` (eps 1e-8) over a list of tensors, updated in
    place from the gradients handed to ``step``.  Its update is optax.adam's,
    lr * mu_hat / (sqrt(nu_hat) + eps).

    With ``schedule`` the LR of each step is ``schedule(count)`` at the
    pre-increment step count, as optax reads it (the first step uses
    schedule(0)).  Without one, the LR lives in the param group, where
    ``Trainer.set_learning_rate`` changes it between steps; it is kept
    rounded to float32, as optax.inject_hyperparams keeps it.
    """

    def __init__(self, tensors, learning_rate: float, schedule=None):
        self.tensors = list(tensors)
        self.schedule = schedule
        self.count = 0
        lr = schedule(0) if schedule is not None else _f32(learning_rate)
        self._lr0 = float(lr)
        self.opt = torch.optim.Adam(self.tensors, lr=self._lr0, eps=1e-8)

    def reset(self):
        """Back to the state of construction: no moments, count 0, the
        initial LR."""
        self.opt.state.clear()
        self.opt.param_groups[0]["lr"] = self._lr0
        self.count = 0

    def step(self, grads):
        for t, g in zip(self.tensors, grads):
            t.grad = g
        if self.schedule is not None:
            self.opt.param_groups[0]["lr"] = float(self.schedule(self.count))
        self.opt.step()
        self.count += 1
        for t in self.tensors:
            t.grad = None


class FusedAdam:
    """Adam over ONE flat vector of every parameter (``fused_adam``): the
    moments are two flat tensors and each step is a handful of full-length
    ops instead of a few per parameter.  The same update as ``Adam``;
    ``learning_rate`` is a float or a schedule read at the pre-increment
    count."""

    def __init__(self, tensors, learning_rate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.tensors = list(tensors)
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps = b1, b2, eps
        n = sum(t.numel() for t in self.tensors)
        ref = self.tensors[0]
        self.mu = torch.zeros(n, dtype=torch.float32, device=ref.device)
        self.nu = torch.zeros_like(self.mu)
        self.count = 0

    def reset(self):
        """Back to the state of construction: zero moments, count 0."""
        self.mu.zero_()
        self.nu.zero_()
        self.count = 0

    @torch.no_grad()
    def step(self, grads):
        flat_g = torch.cat([g.reshape(-1).float() for g in grads])
        count = self.count + 1
        self.mu = self.b1 * self.mu + (1 - self.b1) * flat_g
        self.nu = self.b2 * self.nu + (1 - self.b2) * flat_g.square()
        mu_hat = self.mu / (1 - self.b1 ** count)
        nu_hat = self.nu / (1 - self.b2 ** count)
        lr = (self.learning_rate(self.count) if callable(self.learning_rate)
              else self.learning_rate)
        updates = -lr * mu_hat / (torch.sqrt(nu_hat) + self.eps)
        offset = 0
        for t in self.tensors:
            t.add_(updates[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        self.count = count


def fused_adam(tensors, learning_rate, b1: float = 0.9, b2: float = 0.999,
               eps: float = 1e-8) -> FusedAdam:
    return FusedAdam(tensors, learning_rate, b1, b2, eps)


def make_optimizer(config: YoloConfig, tensors, schedule=None):
    """Adam at ``config.learning_rate`` over ``tensors`` (reference
    models.py:83), or driven by ``schedule``; ``config.fused_optimizer``
    selects the flat-vector ``fused_adam``."""
    if config.fused_optimizer:
        return fused_adam(tensors, schedule if schedule is not None
                          else config.learning_rate)
    return Adam(tensors, config.learning_rate, schedule)


def _f32(x: float) -> float:
    return float(np.float32(x))


# ---------------------------------------------------------------------------
# Optimizer state as the JAX Trainer's checkpoints hold it
# ---------------------------------------------------------------------------

_HYPER = ("b1", "b2", "eps", "eps_root", "learning_rate")
_I32, _F32 = np.dtype(np.int32), np.dtype(np.float32)


def _jax_order(tree) -> list:
    """Indices into ``leaves(tree)`` in ``jax.tree.leaves`` order, which
    sorts dict keys (``beta, gamma, w``; ``b, w``) where ``leaves`` keeps
    insertion order (``w, gamma, beta``; ``w, b``)."""
    counter = iter(range(len(leaves(tree))))
    numbered = tree_map(lambda _: next(counter), tree)
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        elif node is not None:
            out.append(node)

    walk(numbered)
    return out


def _to_jax(t):
    """A parameter-shaped tensor in the JAX layout (OIHW -> HWIO)."""
    return t.permute(2, 3, 1, 0) if t.dim() == 4 else t


def _from_jax(t):
    """The inverse of ``_to_jax`` (HWIO -> OIHW)."""
    return t.permute(3, 2, 0, 1) if t.dim() == 4 else t


def _host(t) -> np.ndarray:
    """A copy of ``t`` as a contiguous numpy array."""
    return t.detach().clone(memory_format=torch.contiguous_format).cpu().numpy()


def _optimizer_layout(optimizer, params) -> list:
    """The leaves of the JAX Trainer's ``opt_state`` for ``optimizer`` over
    ``params``, as [(slot, shape, numpy dtype)].  A slot is "count", a
    hyperparameter's name, ("mu", i) / ("nu", i) for the moment of port
    leaf i, or "mu" / "nu" for the fused flat vectors:

      - ``Adam`` (``optax.inject_hyperparams(optax.adam)``): count, b1, b2,
        eps, eps_root, learning_rate, adam count, mu..., nu...;
      - ``Adam`` with a schedule (``optax.adam(schedule)``): adam count,
        mu..., nu..., schedule count;
      - ``FusedAdam`` (``fused_adam``): count, mu, nu, flat in
        ``ravel_pytree`` order.

    mu... and nu... run in ``jax.tree.leaves`` order, kernels HWIO."""
    tensors = leaves(params)
    if isinstance(optimizer, FusedAdam):
        n = sum(t.numel() for t in tensors)
        return [("count", (), _I32), ("mu", (n,), _F32), ("nu", (n,), _F32)]
    if not isinstance(optimizer, Adam):
        raise TypeError(
            f"checkpoints hold the state of Adam and FusedAdam, not of "
            f"{type(optimizer).__name__}")
    order = _jax_order(params)
    adam = [("count", (), _I32)]
    for kind in ("mu", "nu"):
        adam += [((kind, i), tuple(_to_jax(tensors[i]).shape), _F32)
                 for i in order]
    if optimizer.schedule is not None:
        return adam + [("count", (), _I32)]
    return ([("count", (), _I32)] + [(k, (), _F32) for k in _HYPER]
            + adam)


def _flat_jax(flat, tensors, order):
    """A flat vector over ``tensors`` in the port's order and layout -> the
    same values in ``ravel_pytree`` order (``order``) and the JAX layout."""
    parts, offset = [], 0
    for t in tensors:
        parts.append(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return torch.cat([_to_jax(parts[i]).reshape(-1) for i in order])


def _flat_port(flat, tensors, order):
    """The inverse of ``_flat_jax``."""
    parts, offset = {}, 0
    for i in order:
        shape = _to_jax(tensors[i]).shape
        n = tensors[i].numel()
        parts[i] = _from_jax(flat[offset:offset + n].view(shape))
        offset += n
    return torch.cat([parts[i].reshape(-1) for i in range(len(tensors))])


def optimizer_leaves(optimizer, params) -> list:
    """The state of ``optimizer`` (``Adam`` or ``FusedAdam`` over
    ``leaves(params)``) as the exact list ``jax.tree.leaves(opt_state)``
    that the JAX Trainer saves for its optimizer of the same kind: numpy
    arrays, counts int32, moments in ``jax.tree.leaves`` order with HWIO
    kernels.  A moment that does not exist yet (no step taken) is zeros."""
    tensors = leaves(params)
    layout = _optimizer_layout(optimizer, params)
    if isinstance(optimizer, FusedAdam):
        order = _jax_order(params)
        flat = {"mu": _flat_jax(optimizer.mu, tensors, order),
                "nu": _flat_jax(optimizer.nu, tensors, order)}
    else:
        group = optimizer.opt.param_groups[0]
        hyper = {"b1": group["betas"][0], "b2": group["betas"][1],
                 "eps": group["eps"], "eps_root": 0.0,
                 "learning_rate": group["lr"]}
        state = optimizer.opt.state
    out = []
    for slot, _, dtype in layout:
        if slot == "count":
            v = np.asarray(optimizer.count, dtype)
        elif slot in _HYPER:
            v = np.asarray(hyper[slot], dtype)
        elif isinstance(slot, str):                       # fused mu / nu
            v = _host(flat[slot])
        else:
            kind, i = slot
            t = tensors[i]
            moment = state.get(t, {}).get(
                "exp_avg" if kind == "mu" else "exp_avg_sq")
            v = (_host(_to_jax(moment)) if moment is not None
                 else np.zeros(_to_jax(t).shape, dtype))
        out.append(v)
    return out


def _layout_matches(layout, saved) -> bool:
    """The migration gate: the leaf count, then each leaf's shape and
    dtype."""
    return len(layout) == len(saved) and all(
        tuple(np.shape(s)) == shape and np.asarray(s).dtype == dtype
        for (_, shape, dtype), s in zip(layout, saved))


@torch.no_grad()
def load_optimizer_leaves(optimizer, params, saved) -> None:
    """The inverse of ``optimizer_leaves``: write the saved leaves (numpy
    arrays in optax's layout, already checked against it) into
    ``optimizer``'s state on its device, in place where the state exists.
    The learning rate of an ``Adam`` without a schedule is the saved one;
    b1, b2, eps and eps_root are the optimizer's constants, written as
    optax holds them and not read back."""
    tensors = leaves(params)
    device = tensors[0].device
    layout = _optimizer_layout(optimizer, params)
    count = next(int(v) for (slot, _, _), v in zip(layout, saved)
                 if slot == "count")
    if isinstance(optimizer, FusedAdam):
        order = _jax_order(params)
        for (slot, _, _), v in zip(layout, saved):
            if slot in ("mu", "nu"):
                flat = to_device_async(v, device)
                getattr(optimizer, slot).copy_(
                    _flat_port(flat, tensors, order))
        optimizer.count = count
        return
    state = optimizer.opt.state
    for (slot, _, _), v in zip(layout, saved):
        if slot == "learning_rate":
            optimizer.opt.param_groups[0]["lr"] = float(v)
        elif isinstance(slot, tuple):
            kind, i = slot
            t = tensors[i]
            if not state.get(t):
                state[t] = {
                    "step": torch.tensor(0.0),
                    "exp_avg": torch.zeros_like(
                        t, memory_format=torch.preserve_format),
                    "exp_avg_sq": torch.zeros_like(
                        t, memory_format=torch.preserve_format)}
            state[t]["exp_avg" if kind == "mu" else "exp_avg_sq"].copy_(
                _from_jax(to_device_async(v, device)))
            state[t]["step"].fill_(float(count))
    optimizer.count = count


# ---------------------------------------------------------------------------
# The gradient core and the steps
# ---------------------------------------------------------------------------

def _maybe_encode_on_device(batch: dict, config: YoloConfig,
                            num_classes: int) -> dict:
    """A {'image', 'raw_boxes'} batch (``config.encode_on_device``) -> a
    labels batch, encoded where the batch lies (on the card in training);
    batches that already carry 'labels' pass through."""
    if "labels" in batch:
        return batch
    from .data.encode import encode_labels_torch
    img_hw = batch["image"].shape[-3:-1]
    labels, xywh = encode_labels_torch(
        batch["raw_boxes"], img_hw, config.anchors_flat, num_classes,
        config.strides)
    out = {"image": batch["image"], "labels": labels, "boxes": xywh}
    if "mask" in batch:
        out["mask"] = batch["mask"]
    return out


def _compute_dtype(config: YoloConfig):
    return torch.bfloat16 if config.compute_dtype == "bfloat16" \
        else torch.float32


@contextlib.contextmanager
def _counting_bn_act(name: str, device):
    """The training step's ``forward`` or ``backward`` span; where it
    records, it counts the BN + activation kernels' forwards (``bn_act``)
    or backwards (``bn_act_grad``) that ran inside it."""
    counter = "LAUNCHES" if name == "forward" else "GRAD_LAUNCHES"
    key = "bn_act" if name == "forward" else "bn_act_grad"
    with span(name, device=device) as record:
        before = getattr(bn_act, counter)
        yield
        if record:
            record.count(**{key: getattr(bn_act, counter) - before})


def _make_grad_and_metrics(num_classes: int, config: YoloConfig):
    """(params, state, batch) -> (grads, new_state, metrics): the shared
    core of every train step.  BN batch statistics are over the batch it is
    given; with a (B,) 0/1 "mask" in the batch, padded samples drop out of
    the loss means and the BN statistics."""
    anchors = config.anchors_grouped
    dtype = _compute_dtype(config)
    weights = (config.loss_box_weight, config.loss_conf_weight,
               config.loss_prob_weight)

    def loss_of(params, state, batch, images, mask):
        outs, new_state = network.apply(
            params, state, images, num_classes, train=True,
            compute_dtype=dtype, csp_repeats=config.csp_repeats,
            bn_stats_gradient=config.bn_stats_gradient, sample_mask=mask,
            pallas_wgrad=config.pallas_wgrad)
        total, comps = yolo_loss(
            outs, batch["labels"], batch["boxes"], anchors, config.strides,
            num_classes, config.iou_loss_thresh, weights=weights,
            label_smoothing=config.label_smoothing, return_components=True,
            sample_mask=mask)
        return total, comps, new_state

    def grad_and_metrics(params, state, batch):
        device = batch["image"].device
        sat = config.sat_epsilon > 0.0
        live = [t.detach().requires_grad_(True) for t in leaves(params)]
        with _counting_bn_act("forward", device):
            if batch["image"].dtype == torch.uint8:
                # uint8 wire (config.transfer_uint8): normalise on the device.
                batch = dict(batch,
                             image=batch["image"].to(torch.float32) / 255.0)
            batch = _maybe_encode_on_device(batch, config, num_classes)
            mask = batch.get("mask")
            images = batch["image"]
            if sat:
                # Self-adversarial training: one FGSM step on the images
                # that raises the current loss, then the update on the
                # perturbed batch.
                img = images.detach().requires_grad_(True)
                total, _, _ = loss_of(params, state, batch, img, mask)
            else:
                total, comps, new_state = loss_of(
                    unflatten(params, live), state, batch, images, mask)
        if sat:
            with _counting_bn_act("backward", device):
                (g_img,) = torch.autograd.grad(total, img)
            with _counting_bn_act("forward", device):
                images = torch.clamp(images + config.sat_epsilon
                                     * torch.sign(g_img), 0.0, 1.0)
                total, comps, new_state = loss_of(
                    unflatten(params, live), state, batch, images, mask)
        with _counting_bn_act("backward", device):
            grads = torch.autograd.grad(total, live)
        metrics = {"loss": total.detach(),
                   **{k: v.detach() for k, v in comps.items()}}
        return unflatten(params, grads), new_state, metrics

    return grad_and_metrics


def _accumulated(grad_and_metrics, accum: int):
    """Wrap a core so it loops over ``accum`` micro-batches stacked on a
    leading axis: activations exist for one micro-batch at a time.
    Gradients and metrics are averaged, weighted by each micro-batch's valid
    count when the batch carries a mask; BN statistics update sequentially
    through the micro-batches, and an all-padding micro-batch leaves them
    as they were."""
    if accum <= 1:
        return grad_and_metrics

    def accumulated(params, state, batch):
        has_mask = "mask" in batch
        gsum = tree_map(torch.zeros_like, params)
        msum, wsum, st = None, 0.0, state
        for i in range(accum):
            micro = tree_map(lambda x: x[i], batch)
            g, new_st, m = grad_and_metrics(params, st, micro)
            w = micro["mask"].sum(dtype=torch.float32) if has_mask else 1.0
            gsum = tree_map(lambda a, b: a + w * b, gsum, g)
            if has_mask:
                new_st = tree_map(lambda n, o: torch.where(w > 0, n, o),
                                   new_st, st)
            st = new_st
            m = tree_map(lambda x: x * w, m)
            msum = m if msum is None else tree_map(torch.add, msum, m)
            wsum = wsum + w
        denom = (torch.clamp(wsum, min=1e-6) if torch.is_tensor(wsum)
                 else max(wsum, 1e-6))
        grads = tree_map(lambda g: g / denom, gsum)
        metrics = tree_map(lambda x: x / denom, msum)
        return grads, st, metrics

    return accumulated


def chunk_batch(batch: dict, accum: int) -> dict:
    """(B, ...) batch -> (accum, B/accum, ...) micro-batch stack for the
    gradient-accumulation step.  B must divide evenly."""
    def chunk(x):
        b = x.shape[0]
        if b % accum:
            raise ValueError(f"batch size {b} not divisible by "
                             f"grad_accum_steps {accum}")
        return x.reshape(accum, b // accum, *x.shape[1:])

    return tree_map(chunk, batch)


_SMALL_POW2 = (1, 2, 4, 8, 16, 32)


def aligned_batch(b: int) -> bool:
    """Batch sizes the JAX package's TPU tiling likes: small (<=32), or a
    multiple of 32.  Kept because they decide which batches get per-chunk
    BN statistics (``Trainer._chunked_step``), which is part of the
    result."""
    return b <= 32 or b % 32 == 0


def aligned_size(b: int) -> int:
    """Smallest aligned batch >= b (next power of two up to 32, then the
    next multiple of 32)."""
    if b <= 32:
        return next(p for p in _SMALL_POW2 if p >= b)
    return -(-b // 32) * 32


def decompose_batch(b: int):
    """Split a non-aligned batch into aligned chunks: the largest multiple
    of 32, plus the remainder padded up to the next power of two.  Returns
    [(chunk_size, n_valid)]."""
    if aligned_batch(b):
        return [(b, b)]
    main = 32 * (b // 32)
    rem = b - main
    tgt = next(p for p in _SMALL_POW2 if p >= rem)
    return [(main, main), (tgt, rem)]


def pad_mask_batch(batch: dict, target: int) -> dict:
    """Pad every leaf to ``target`` samples on axis 0 with zeros and attach
    a (target,) float32 0/1 validity mask: the step on it equals the trimmed
    batch's step."""
    b = _batch_size(batch)
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(b, dtype=torch.float32,
                          device=leaves(batch)[0].device)
    if b == target and "mask" in batch:
        return batch
    pad = target - b

    def pad_leaf(x):
        return torch.cat([x, x.new_zeros((pad, *x.shape[1:]))])

    out = {k: tree_map(pad_leaf, v) for k, v in batch.items() if k != "mask"}
    out["mask"] = pad_leaf(mask)
    return out


# ---------------------------------------------------------------------------
# Data-parallel combination: one all-reduce of one slab
# ---------------------------------------------------------------------------

def _pack(tensors, w):
    """One float32 buffer: every tensor flattened and multiplied by the
    rank's weight ``w`` (a 0-d float32 tensor), then ``w`` itself."""
    one = torch.ones(1, dtype=torch.float32, device=w.device)
    return torch.cat([t.reshape(-1) for t in tensors] + [one]).mul_(w)


def _unpack(flat, tensors):
    """The summed buffer divided by the summed weight (at least 1, as the
    JAX package clamps it), as tensors shaped like ``tensors``."""
    mean = flat[:-1] / torch.clamp(flat[-1], min=1.0)
    parts = mean.split([t.numel() for t in tensors])
    return [p.view(t.shape) for p, t in zip(parts, tensors)]


def _allreduce_slab(mesh, tensors, w):
    """The ``w``-weighted mean of ``tensors`` over the mesh's ranks in ONE
    collective: pack every tensor × w and w into one float32 buffer, one
    ``all_reduce(SUM)``, divide by the summed w.  With w the rank's valid
    count this is the valid-count-weighted mean of the JAX mesh step
    (train.py:438-465 there); with equal counts, the plain mean.  The JAX
    package's compiled step holds 1-12 all-reduces after XLA's combiner;
    this one holds one, masked or not.  Pack, all-reduce and unpack run
    in an ``allreduce`` span."""
    with span("allreduce", device=w.device):
        flat = _pack(tensors, w)
        dist.all_reduce(flat, group=mesh.group)
        return _unpack(flat, tensors)


def _combine(mesh, grads, new_state, metrics, w):
    """(grads, new BN state, metrics) weighted by ``w`` and averaged over
    the mesh through one ``_allreduce_slab``."""
    parts = (grads, new_state, metrics)
    means = iter(_allreduce_slab(mesh, [t for p in parts for t in leaves(p)],
                                 w))
    return tuple(unflatten(p, means) for p in parts)


def _rank_weight(batch, masked: bool, accum: int) -> torch.Tensor:
    """This rank's weight in the combination: its valid-sample count (the
    mask's sum) when ``masked``, else its sample count."""
    image = batch["image"]
    if masked:
        return batch["mask"].sum(dtype=torch.float32)
    if "mask" in batch:
        raise ValueError("a batch with a validity mask needs the masked "
                         "step (masked=True)")
    count = image.shape[0] * (image.shape[1] if accum > 1 else 1)
    # A fill on the device: a host-to-device copy would wait for the work
    # queued before it.
    return torch.full((), float(count), device=image.device)


def _local_grads(num_classes: int, config: YoloConfig, masked: bool):
    """(params, state, batch) -> (grads, new_state, metrics, w) on this
    rank's shard, with no collective: the gradient core (accumulated over
    micro-batches when ``config.grad_accum_steps > 1``; the micro-steps stay
    local and an all-padding micro-batch leaves this rank's BN statistics
    as they were) and the rank's weight."""
    accum = config.grad_accum_steps
    core = _accumulated(_make_grad_and_metrics(num_classes, config), accum)

    def local(params, state, batch):
        w = _rank_weight(batch, masked, accum)
        return (*core(params, state, batch), w)

    return local


def _update(optimizer, grads) -> None:
    """``optimizer.step`` over the leaves of ``grads``, in an ``optimizer``
    span."""
    flat = leaves(grads)
    with span("optimizer", device=flat[0].device):
        optimizer.step(flat)


def make_train_step(num_classes: int, config: YoloConfig, optimizer,
                    mesh=None, masked: bool = False):
    """The train step: (params, state, batch) -> (new_state, metrics), with
    ``optimizer`` (built over ``params``' tensors) updating the parameters
    in place.  batch is {'image': (B,H,W,3), 'labels': [3 grids],
    'boxes': (B,M,4)} of tensors on the parameters' device (or
    {'image', 'raw_boxes'} with ``encode_on_device``).  With
    ``config.grad_accum_steps > 1`` the batch must be pre-chunked by
    ``chunk_batch``.

    On a ``mesh`` the batch is this rank's shard: local gradients (BN
    statistics over the shard), then one ``_allreduce_slab`` of the
    gradients, the new BN state and the metrics, then the optimizer.  Every
    rank applies the same update, so the parameters stay replicated.
    ``masked`` (mesh only): the shard carries a (B,) 0/1 "mask" and each
    rank weighs by its valid count, so the update is the mean over every
    valid sample of the global batch however the padding falls; a rank
    that holds only padding contributes nothing."""
    if mesh is None:
        grad_and_metrics = _accumulated(
            _make_grad_and_metrics(num_classes, config),
            config.grad_accum_steps)

        def step(params, state, batch):
            grads, new_state, metrics = grad_and_metrics(params, state, batch)
            _update(optimizer, grads)
            return new_state, metrics

        return step

    local = _local_grads(num_classes, config, masked)

    def mesh_step(params, state, batch):
        grads, new_state, metrics = _combine(mesh, *local(params, state,
                                                          batch))
        _update(optimizer, grads)
        return new_state, metrics

    return mesh_step


def make_train_step_twophase(num_classes: int, config: YoloConfig,
                             optimizer, mesh):
    """The mesh train step in two phases: (1) local gradients with no
    collective, then a device synchronize and a ``barrier``, so every rank
    reaches (2), the slab's all-reduce and the update, together.  The same
    arithmetic as ``make_train_step(mesh=...)``, so the same result bit for
    bit.  No gradient accumulation (as in the JAX package)."""
    if config.grad_accum_steps > 1:
        raise ValueError(
            "make_train_step_twophase does not support grad_accum_steps>1 — "
            "use make_train_step(mesh=...), which does")
    local = _local_grads(num_classes, config, masked=False)

    def step(params, state, batch):
        parts = local(params, state, batch)
        if mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.group)
        grads, new_state, metrics = _combine(mesh, *parts)
        _update(optimizer, grads)
        return new_state, metrics

    return step


def make_eval_step(num_classes: int, config: YoloConfig, mesh=None,
                   masked: bool = False):
    """Validation loss with BN in inference mode, in float32; ``masked``:
    the batch carries a (B,) 0/1 "mask" and the loss is the mean over its
    valid samples.  On a ``mesh`` the batch is this rank's shard and the
    loss is the mean over the ranks, weighted by valid counts when
    ``masked`` (one ``_allreduce_slab``)."""
    anchors = config.anchors_grouped

    @torch.no_grad()
    def step(params, state, batch):
        if batch["image"].dtype == torch.uint8:
            batch = dict(batch, image=batch["image"].to(torch.float32) / 255.0)
        batch = _maybe_encode_on_device(batch, config, num_classes)
        mask = batch.get("mask") if masked else None
        outs, _ = network.apply(params, state, batch["image"], num_classes,
                                train=False, csp_repeats=config.csp_repeats)
        return yolo_loss(outs, batch["labels"], batch["boxes"], anchors,
                         config.strides, num_classes, config.iou_loss_thresh,
                         weights=(config.loss_box_weight,
                                  config.loss_conf_weight,
                                  config.loss_prob_weight),
                         sample_mask=mask)

    if mesh is None:
        return step

    def mesh_step(params, state, batch):
        w = _rank_weight(batch, masked, 1)
        (loss,) = _allreduce_slab(mesh, [step(params, state, batch)], w)
        return loss

    return mesh_step


class _Shard(dict):
    """This rank's rows of a global batch, already on the mesh's device
    (``Trainer._place``); ``digest`` is the global batch's
    (``_batch_digest``) when the producer was asked for it."""
    digest = None


def _batch_digest(batch) -> int:
    """An order-sensitive checksum (CRC-32) of a host batch's bytes."""
    crc = 0
    for x in leaves(batch):
        crc = zlib.crc32(np.ascontiguousarray(np.asarray(x)).view(np.uint8),
                         crc)
    return crc


class Trainer:
    """Owns (params, state, optimizer) and runs epochs over a DataGenerator.

    ``optimizer``: a function of the parameter tensors that returns an
    optimizer with ``step(grads)`` (default: ``make_optimizer``).  The
    device is the card unless the caller asks for the CPU, and raises
    without CUDA.

    Data-parallel: ``mesh`` (``parallel.mesh.make_mesh``), or
    ``config.num_devices > 1``, which builds ``make_mesh(num_devices,
    device)`` over the process group.  Then the device is the mesh's, rank
    0's params and BN state are broadcast to every rank at construction,
    each step runs on this rank's rows of the global batch the generator
    yields (every rank must see the same batches: seed the generator), only
    rank 0 writes checkpoints and prints, and ``fit`` checks at its first
    batch that every rank holds the same one.
    """

    def __init__(self, config: YoloConfig, num_classes: int, params, state,
                 mesh=None, schedule=None, optimizer=None, device="cuda"):
        require_yolov4(config, "Trainer")
        self.config = config
        self.num_classes = num_classes
        if mesh is None and config.num_devices > 1:
            mesh = make_mesh(config.num_devices, device)
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(
            device)

        def place(t):
            return torch.as_tensor(t).detach().to(self.device, torch.float32,
                                                  copy=True)

        if self.device.type == "cuda":
            # The kernels every step launches, built now and side by side
            # rather than one after the other in the first step.
            kbuild.build_many(("bn_act", "wgrad_3x3") if config.pallas_wgrad
                              else ("bn_act",))
        self.params = tree_map(place, params)
        self.state = tree_map(place, state)
        if mesh is not None:
            replicate(self.params, mesh)
            replicate(self.state, mesh)
        tensors = leaves(self.params)
        self.optimizer = (optimizer(tensors) if optimizer is not None
                          else make_optimizer(config, tensors, schedule))
        self._step = make_train_step(num_classes, config, self.optimizer,
                                     mesh)
        self._step_masked = None   # lazy: mesh pad-and-mask variant
        self._eval = make_eval_step(num_classes, config, mesh)
        self._eval_masked = None   # lazy: pad-and-mask eval (ragged tails)
        self._chunk_grad = None    # lazy: gradient core for aligned chunks
        self._digest_wanted = False  # fit's same-batch check is pending
        self.global_step = 0
        self.history = []

    @property
    def _writer(self) -> bool:
        """Whether this process writes files and prints (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _place(self, batch, batch_axis: int = 0):
        """The batch on the device; on a mesh, this rank's rows of it (a
        ``_Shard``; ``batch_axis`` 1 for micro-batch stacks)."""
        if self.mesh is not None:
            return _Shard(shard_batch(batch, self.mesh, batch_axis))
        return tree_map(lambda x: torch.as_tensor(x).to(self.device), batch)

    def _prefetch_place(self, batch):
        """Producer-thread placement: copies a full batch (on a mesh, this
        rank's rows of it) to the card from pinned host memory without
        blocking, so batch N+1's copy overlaps batch N's step (both on the
        current stream, so the step sees the copied bytes).  Batches that
        train_step pads or chunks stay on the host."""
        b = _batch_size(batch)
        if self.mesh is not None:
            if self.config.grad_accum_steps != 1 or b % self.mesh.size:
                return batch
            shard = self._place(batch)
            if self._digest_wanted:
                shard.digest = _batch_digest(batch)
            return shard
        if self.config.grad_accum_steps != 1 or not aligned_batch(b):
            return batch
        return tree_map(lambda x: to_device_async(x, self.device), batch)

    def train_step(self, batch) -> dict:
        """Run one optimizer step; never drops samples.  A non-aligned batch
        on one device runs as aligned chunks; a batch that does not split
        into ``grad_accum_steps`` x mesh-size micro-batches is padded with a
        validity mask (on a mesh, the masked step then weighs each rank by
        its valid count).  On a mesh ``batch`` is the global batch, or this
        rank's ``_Shard`` of it from ``_place``."""
        with span("train_step", id=self.global_step) as record:
            if record:
                record.count(images=_batch_size(batch))
            return self._train_step(batch)

    def _train_step(self, batch) -> dict:
        if not isinstance(batch, _Shard):
            batch = tree_map(torch.as_tensor, batch)
            accum = self.config.grad_accum_steps
            b = _batch_size(batch)
            if accum == 1 and self.mesh is None and not aligned_batch(b):
                return self._chunked_step(batch)
            # Full batches (batch_size per rank) must split into accum
            # micro-batches on every rank; a ragged tail is padded.
            if self.config.batch_size % accum:
                raise ValueError(
                    f"full batches of {self.config.batch_size} samples "
                    f"per device cannot be split into grad_accum_steps="
                    f"{accum} micro-batches — lower grad_accum_steps or "
                    "raise batch_size")
            multiple = accum * (self.mesh.size if self.mesh is not None
                                else 1)
            if b % multiple:
                batch = pad_mask_batch(batch, -(-b // multiple) * multiple)
            if accum > 1:
                batch = chunk_batch(batch, accum)
            batch = self._place(batch, batch_axis=1 if accum > 1 else 0)
        step = self._step
        if self.mesh is not None and "mask" in batch:
            if self._step_masked is None:
                self._step_masked = make_train_step(
                    self.num_classes, self.config, self.optimizer, self.mesh,
                    masked=True)
            step = self._step_masked
        self.state, metrics = step(self.params, self.state, batch)
        self.global_step += 1
        return metrics

    def _chunked_step(self, batch) -> dict:
        """One optimizer step over a non-aligned batch as aligned chunks:
        each chunk has its own BN batch statistics; gradients, BN states and
        metrics combine weighted by valid counts, then one Adam update."""
        if self._chunk_grad is None:
            self._chunk_grad = _make_grad_and_metrics(self.num_classes,
                                                      self.config)
        gs, sts, ms, ws = [], [], [], []
        offset = 0
        for size, valid in decompose_batch(_batch_size(batch)):
            piece = tree_map(lambda x: x[offset:offset + valid], batch)
            offset += valid
            if valid < size:
                piece = pad_mask_batch(piece, size)
            g, st, m = self._chunk_grad(self.params, self.state,
                                        self._place(piece))
            gs.append(g)
            sts.append(st)
            ms.append(m)
            ws.append(float(valid))
        wsum = sum(ws)

        def wavg(*xs):
            return sum(w * x for w, x in zip(ws, xs)) / wsum

        grads = tree_map(wavg, *gs)
        self.state = tree_map(wavg, *sts)
        metrics = tree_map(wavg, *ms)
        _update(self.optimizer, grads)
        self.global_step += 1
        return metrics

    def _check_same_batch(self, batch) -> None:
        """Raise on every rank unless every rank holds rank 0's batch: a
        broadcast of rank 0's checksum, then an all-reduce of the
        mismatches.  Once per ``fit``."""
        self._digest_wanted = False
        digest = (batch.digest if isinstance(batch, _Shard)
                  else _batch_digest(batch))
        mine = torch.tensor(digest, dtype=torch.int64,
                            device=self.mesh.device)
        ref = mine.clone()
        dist.broadcast(ref, 0, group=self.mesh.group)
        bad = (ref != mine).to(torch.int64)
        dist.all_reduce(bad, group=self.mesh.group)
        if int(bad):
            raise RuntimeError(
                f"fit: {int(bad)} of {self.mesh.size} ranks hold another "
                "first batch than rank 0; every rank must draw the same "
                "global batches — seed the generator (DataGenerator(seed="
                "...)), whose default seed=None differs per process")

    # -- mutable learning rate (callback-driven scheduling) ---------------
    def _lr_group(self) -> dict:
        opt = self.optimizer
        if not isinstance(opt, Adam) or opt.schedule is not None:
            raise RuntimeError(
                "this Trainer's optimizer does not expose a mutable "
                "learning rate (it was built with a schedule or a "
                "custom/fused optimizer) — construct the Trainer without "
                "`schedule`, or use train.cosine_annealing_schedule")
        return opt.opt.param_groups[0]

    @property
    def learning_rate(self) -> float:
        """The LR the next optimizer step will apply."""
        return float(self._lr_group()["lr"])

    def set_learning_rate(self, lr: float) -> None:
        """Set the LR applied from the next step on (rounded to float32, as
        the JAX Trainer holds it)."""
        self._lr_group()["lr"] = _f32(lr)

    def eval_step(self, batch):
        """Validation loss on one batch.  A batch that does not split evenly
        across the mesh (or is non-aligned on one device) is padded with a
        validity mask and gives exactly the trimmed batch's loss."""
        batch = tree_map(torch.as_tensor, batch)
        b = _batch_size(batch)
        if self.mesh is not None:
            n = self.mesh.size
            target = -(-b // n) * n
        else:
            target = aligned_size(b) if not aligned_batch(b) else b
        if target != b:
            batch = pad_mask_batch(batch, target)
            if self._eval_masked is None:
                self._eval_masked = make_eval_step(
                    self.num_classes, self.config, self.mesh, masked=True)
            return self._eval_masked(self.params, self.state,
                                     self._place(batch))
        return self._eval(self.params, self.state, self._place(batch))

    # -- checkpoint / resume ------------------------------------------------
    def save_checkpoint(self, path: str, epoch: int = -1):
        """Full training checkpoint: params + BN state + optimizer state, in
        the JAX Trainer's file layout (``optimizer_leaves``).  On a mesh
        rank 0 alone writes while the other ranks wait for it."""
        from . import checkpoint as ckpt

        def write():
            params, state = network.params_to_jax(self.params, self.state)
            ckpt.save_npz(path, params,
                          {"model": state,
                           "opt_leaves": optimizer_leaves(self.optimizer,
                                                          self.params)},
                          step=self.global_step, extra={"epoch": epoch})

        on_rank0(self.mesh, write)

    @torch.no_grad()
    def restore_checkpoint(self, path: str) -> int:
        """Restore a full training checkpoint of either package; returns the
        next epoch.  Parameters are written into the tensors the optimizer
        holds.  Optimizer state whose leaves do not match this optimizer's
        layout (count, then each leaf's shape and dtype) is reinitialized,
        as in the JAX Trainer.  On a mesh every rank reads the same file,
        so the ranks stay equal."""
        from . import checkpoint as ckpt
        params, wrapped, step, extra = ckpt._read_npz(path)
        if len(leaves(params)) != len(leaves(self.params)):
            raise ValueError(f"{path}: its parameters do not fit this "
                             "Trainer's model")

        def write(dst, src):
            src = _from_jax(to_device_async(src, self.device))
            if src.shape != dst.shape:
                raise ValueError(f"{path}: a parameter of shape "
                                 f"{tuple(src.shape)} where this Trainer's "
                                 f"model has {tuple(dst.shape)}")
            dst.copy_(src)

        tree_map(write, self.params, params)
        self.state = tree_map(lambda _, a: to_device_async(a, self.device),
                              self.state, wrapped["model"])
        saved_leaves = wrapped["opt_leaves"]
        layout = _optimizer_layout(self.optimizer, self.params)
        if _layout_matches(layout, saved_leaves):
            load_optimizer_leaves(self.optimizer, self.params, saved_leaves)
        else:
            # A checkpoint from a different optimizer format: params, step
            # and epoch restore, the moments restart.
            print(f"restore_checkpoint: optimizer state in {path} "
                  f"({len(saved_leaves)} leaves) does not match the current "
                  f"optimizer's layout ({len(layout)} leaves, "
                  "shape/dtype-checked); reinitializing optimizer state "
                  "(params/step/epoch are restored)")
            self.optimizer.reset()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.global_step = step
        return int(extra.get("epoch", -1)) + 1

    def fit(self, train_gen, epochs: int, val_gen=None, initial_epoch: int = 0,
            callbacks: Optional[Iterable[Callable]] = None,
            log_every: int = 50, verbose: bool = True,
            resume_dir: Optional[str] = None):
        """Epoch loop with prefetching (reference fit, models.py:100-107 —
        minus its crash when val_gen is None).  Returns the history: one
        {'epoch', 'loss', 'time'[, 'val_loss']} entry per epoch.

        With ``resume_dir`` set, a full checkpoint (params, BN state,
        optimizer) is written to ``resume_dir/latest.npz`` after every
        epoch's callbacks, and a later ``fit`` with the same directory
        resumes from it at the next epoch.

        On a mesh only rank 0 prints, and the first batch is checked to be
        the same on every rank (a broadcast of rank 0's checksum): ranks
        that draw different batches raise, naming the generator's seed.
        """
        import os

        from .data.pipeline import prefetch

        verbose = verbose and self._writer
        self._digest_wanted = self.mesh is not None and self.mesh.size > 1

        latest = (os.path.join(resume_dir, "latest.npz")
                  if resume_dir else None)
        if latest and os.path.exists(latest):
            initial_epoch = max(initial_epoch, self.restore_checkpoint(latest))
            if verbose:
                print(f"resumed from {latest} at epoch {initial_epoch}")
        elif resume_dir:
            os.makedirs(resume_dir, exist_ok=True)

        for epoch in range(initial_epoch, epochs):
            for cb in (callbacks or []):
                begin = getattr(cb, "on_epoch_begin", None)
                if begin is not None:
                    begin(self, epoch)
            t0 = time.time()
            # Losses stay on the device until a log point or the epoch's
            # end, so the host does not wait for each step.
            n, losses = 0, []
            for batch in prefetch(train_gen, epochs=1,
                                  transform=self._prefetch_place):
                if self._digest_wanted:
                    self._check_same_batch(batch)
                metrics = self.train_step(batch)
                n += 1
                losses.append(metrics["loss"])
                if verbose and n % log_every == 0:
                    mean = sum(float(l) for l in losses) / n
                    print(f"epoch {epoch} step {n}/{len(train_gen)} "
                          f"loss {mean:.4f}")
            if n == 0:
                raise ValueError(
                    f"epoch {epoch} ran zero optimizer steps — the "
                    "generator yielded no batches; grow the dataset")
            loss_sum = float(sum(float(l) for l in losses))
            entry = {"epoch": epoch, "loss": loss_sum / n,
                     "time": time.time() - t0}
            if val_gen is not None:
                vlosses = [self.eval_step(batch)
                           for batch in prefetch(val_gen, epochs=1)]
                entry["val_loss"] = (sum(float(v) for v in vlosses)
                                     / max(len(vlosses), 1))
            self.history.append(entry)
            if verbose:
                print({k: (f"{v:.4f}" if isinstance(v, float) else v)
                       for k, v in entry.items()})
            for cb in (callbacks or []):
                cb(self, entry)
            if latest:
                self.save_checkpoint(latest, epoch=epoch)
        return self.history
