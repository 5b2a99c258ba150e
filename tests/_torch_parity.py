"""Shared helpers for the tests that hold the PyTorch port against the JAX
package: one set of numpy inputs, made from a seed, fed to both sides.

The port never imports this module.  Parameters are drawn the way
``weights.random_darknet_bytes`` draws them (non-trivial BN statistics, so
folding matters; ~unit-gain kernels, so activations stay O(1) through the
depth) and kept in the JAX package's layout (HWIO kernels, numpy arrays);
``yolov4tpu_torch.models.network.params_from_jax`` carries them across.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from yolov4tpu import weights as jweights
from yolov4tpu.models import network as jnetwork

SHALLOW = (1, 1, 1, 1, 1)
IMG = 64

# The suite runs several pytest workers side by side on a few cores.
torch.set_num_threads(1)


@functools.lru_cache(maxsize=None)
def well_conditioned(num_classes: int, seed: int = 0, csp_repeats=SHALLOW):
    """(params, state) numpy pytrees in the JAX layout, drawn in the order
    and with the distributions of ``random_darknet_bytes``.  Cached: read
    them, do not write them."""
    rng = np.random.default_rng(seed)
    convs, bn = [], []
    for spec in jnetwork.conv_specs(num_classes, tuple(csp_repeats)):
        f, k, cin = spec.filters, spec.kernel_size, spec.in_ch
        p = {}
        if spec.batch_norm:
            p["beta"] = rng.normal(0.0, 0.1, f).astype(np.float32)
            p["gamma"] = rng.uniform(0.8, 1.2, f).astype(np.float32)
            bn.append({"mean": rng.normal(0.0, 0.1, f).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, f).astype(np.float32)})
        else:
            p["b"] = rng.normal(0.0, 0.1, f).astype(np.float32)
            bn.append(None)
        w = rng.normal(0.0, 1.0 / np.sqrt(k * k * cin), (f, cin, k, k))
        p["w"] = np.ascontiguousarray(w.astype(np.float32).transpose(2, 3, 1, 0))
        convs.append(p)
    return {"convs": convs}, {"bn": bn}


@functools.lru_cache(maxsize=None)
def torch_params(num_classes: int, seed: int = 0):
    """``well_conditioned`` carried into the port by ``params_from_jax``.
    Cached: read them, do not write them."""
    from yolov4tpu_torch.models.network import params_from_jax
    return params_from_jax(*well_conditioned(num_classes, seed))


def images(seed: int, batch: int, img: int = IMG) -> np.ndarray:
    """(B, img, img, 3) uint8 rasters with some spatial structure."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (batch, img // 8, img // 8, 3))
    smooth = np.repeat(np.repeat(coarse, 8, axis=1), 8, axis=2)
    noise = rng.normal(0.0, 20.0, smooth.shape)
    return np.clip(smooth + noise, 0, 255).astype(np.uint8)


jax_fold_bn = jax.jit(jnetwork.fold_bn)


@functools.lru_cache(maxsize=None)
def _jax_forward(num_classes: int, s2d_stem: bool, compute_dtype):
    return jax.jit(functools.partial(
        jnetwork.apply_folded, num_classes=num_classes,
        compute_dtype=compute_dtype, csp_repeats=SHALLOW, s2d_stem=s2d_stem))


def jax_raws(params, state, imgs: np.ndarray, num_classes: int,
             s2d_stem: bool = True, compute_dtype=jnp.float32):
    """The JAX folded forward's raw NHWC grids, as numpy arrays."""
    fwd = _jax_forward(num_classes, s2d_stem, compute_dtype)
    return [np.asarray(o) for o in fwd(jax_fold_bn(params, state),
                                       np.asarray(imgs, np.float32))]


@functools.lru_cache(maxsize=None)
def calibrated(num_classes: int, seed: int = 0, target: float = 30.0):
    """Well-conditioned shallow params whose head biases are shifted (by the
    JAX package's ``calibrate_detection_density``) so ~``target`` boxes per
    image clear the 0.3 score threshold, with the nearest score kept as far
    from it as the calibration can.  Returns (params, state, imgs (B,H,W,3)
    float32 in [0, 1]) — read them, do not write them."""
    params, state = well_conditioned(num_classes, seed)
    imgs = images(seed, 2).astype(np.float32) / 255.0
    raws = jax_raws(params, state, imgs, num_classes)
    params, _ = jweights.calibrate_detection_density(
        params, raws, num_classes, target_per_image=target)
    return params, state, imgs


@functools.lru_cache(maxsize=None)
def port_calibrated(num_classes: int, seed: int = 0, target: float = 30.0):
    """``calibrated`` made on the port's side alone (its float32 forward
    and its ``calibrate_detection_density``), so no JAX program is
    compiled: (params, state) of CPU tensors and imgs (B,H,W,3) float32 in
    [0, 1] — read them, do not write them."""
    from yolov4tpu_torch import weights as tweights
    from yolov4tpu_torch.models import network as tnetwork
    params, state = torch_params(num_classes, seed)
    imgs = images(seed, 2).astype(np.float32) / 255.0
    with torch.inference_mode():
        raws = tnetwork.apply_folded(tnetwork.fold_bn(params, state),
                                     torch.from_numpy(imgs), num_classes,
                                     csp_repeats=SHALLOW)
    params, _ = tweights.calibrate_detection_density(
        params, [r.numpy() for r in raws], num_classes,
        target_per_image=target)
    return params, state, imgs


def small_tree(seed: int = 0, convs=((3, 3, 8, True), (1, 8, 6, False),
                                      (3, 8, 4, True))):
    """(params, state) numpy pytrees in the JAX layout with the model's
    structure at small widths: one conv per (kernel, in, out, has BN) of
    ``convs``; a conv without BN has a bias and None state, as the head
    convs do."""
    rng = np.random.default_rng(seed)
    layers, bn = [], []
    for k, cin, cout, has_bn in convs:
        p = {"w": rng.normal(size=(k, k, cin, cout)).astype(np.float32)}
        if has_bn:
            p["gamma"] = rng.uniform(0.5, 1.5, cout).astype(np.float32)
            p["beta"] = rng.normal(size=cout).astype(np.float32)
            bn.append({"mean": rng.normal(size=cout).astype(np.float32),
                       "var": rng.uniform(0.5, 1.5, cout).astype(np.float32)})
        else:
            p["b"] = rng.normal(size=cout).astype(np.float32)
            bn.append(None)
        layers.append(p)
    return {"convs": layers}, {"bn": bn}


def remove_at_teardown(request, folder) -> None:
    """Remove a module fixture's folder at its teardown, unless a test of
    the session has failed: the ranks' weights, checkpoints and outputs run
    to hundreds of MB a module, and a whole run would otherwise keep them
    all until it ends."""
    import shutil
    if not request.session.testsfailed:
        shutil.rmtree(folder, ignore_errors=True)


@pytest.fixture
def no_cluster(monkeypatch):
    """No process group and no cluster variables (torchrun's, or those by
    which ``init_distributed`` refuses a one-rank group); a group the test
    makes is destroyed after it.  Import it into a test module to use it."""
    import torch.distributed as dist

    from yolov4tpu_torch.parallel import mesh
    assert not dist.is_initialized()
    for name in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
                 "LOCAL_RANK", *(n for n, _ in mesh._MULTI_HOST_HINTS)):
        monkeypatch.delenv(name, raising=False)
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def to_numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_detections_equal(got, want, box_atol: float, score_atol: float):
    """Two combined-NMS output tuples (boxes, scores, classes, valid):
    valid counts and classes equal, boxes and scores within the tolerances."""
    got = [to_numpy(o) for o in got]
    want = [to_numpy(o) for o in want]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[2], want[2])
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=score_atol)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=box_atol)


def train_batch(seed: int, batch: int, num_classes: int, img: int = IMG,
                n_boxes: int = 4):
    """A host-encoded training batch (numpy, JAX layout): images in [0, 1],
    the three label grids and the xywh boxes, from ``n_boxes`` random boxes
    per image."""
    from yolov4tpu.config import YoloConfig
    from yolov4tpu.data.encode import preprocess_true_boxes
    rng = np.random.default_rng(seed)
    boxes = np.zeros((batch, 100, 5), np.float32)
    for b in range(batch):
        for j in range(n_boxes):
            x1, y1 = rng.uniform(0, img * 0.6, 2)
            w, h = rng.uniform(img / 8, img * 0.4, 2)
            boxes[b, j] = [x1, y1, x1 + w, y1 + h, rng.integers(num_classes)]
    boxes[..., :4] = np.floor(boxes[..., :4])
    labels, xywh = preprocess_true_boxes(
        boxes, (img, img), YoloConfig().anchors_flat, num_classes)
    return {"image": images(seed, batch, img).astype(np.float32) / 255.0,
            "labels": labels, "boxes": xywh}, boxes


def to_torch(tree):
    """numpy leaves (dicts and lists) -> CPU tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_torch(v) for v in tree]
    return None if tree is None else torch.from_numpy(np.asarray(tree))


def conv_leaves(tree):
    """[(conv index, key, numpy array in the JAX layout)] of a params-shaped
    tree from either package (OIHW kernels back to HWIO)."""
    out = []
    for i, p in enumerate(tree["convs"]):
        for k in sorted(p):
            v = p[k]
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().numpy()
                if k == "w":
                    v = v.transpose(2, 3, 1, 0)
            out.append((i, k, np.asarray(v)))
    return out


def rel_rms(got, want) -> float:
    """RMS of the difference over the RMS of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / max(np.sqrt(np.mean(want ** 2)), 1e-30))


def adam_step_agreement(before, after_jax, after_torch, lr: float):
    """One Adam step from the same parameters on both sides: (fraction of
    entries whose updates agree to 1e-2 * lr, largest update difference
    over lr).  A first Adam step moves every entry by lr * g / (|g| + eps),
    i.e. by +-lr wherever |g| >> eps, so updates agree wherever the two
    gradients agree in sign; an entry whose gradient sign differs moves by
    up to 2 * lr."""
    agree = total = 0
    worst = 0.0
    for (_, _, b), (_, _, j), (_, _, t) in zip(
            conv_leaves(before), conv_leaves(after_jax),
            conv_leaves(after_torch)):
        d = np.abs((t - b) - (j - b))
        agree += int((d <= 1e-2 * lr).sum())
        total += d.size
        worst = max(worst, float(d.max()) / lr)
    return agree / total, worst


class DPWorkers:
    """Two ranks of ``tests/_torch_dp_worker.py``, started at construction
    in their own processes (gloo on the CPU, rendezvous through a FileStore
    in ``work``), so the caller can compute while they run; ``results()``
    waits for both (each with a timeout) and returns their outputs, rank 0
    first.  ``spec``: {"num_classes", "scenarios": [...]}; ``params``,
    ``state``: the port's CPU tensors (``torch_params``); ``batches``:
    name -> a global batch of numpy arrays; ``arrays``: name -> a numpy
    array, stored in inputs.npz under its name."""

    def __init__(self, work, spec, params, state, batches, world: int = 2,
                 timeout: float = 120.0, arrays=None):
        import json
        import os
        import pathlib
        import subprocess
        import sys

        self.work = pathlib.Path(work)
        self.timeout = timeout
        (self.work / "spec.json").write_text(json.dumps(spec))
        torch.save({"params": params, "state": state},
                   self.work / "params.pt")
        flat = {}
        for name, b in batches.items():
            flat[f"{name}/image"] = b["image"]
            flat[f"{name}/boxes"] = b["boxes"]
            for i, g in enumerate(b["labels"]):
                flat[f"{name}/labels/{i}"] = g
            if "mask" in b:
                flat[f"{name}/mask"] = b["mask"]
        flat.update(arrays or {})
        np.savez(self.work / "inputs.npz", **flat)
        here = pathlib.Path(__file__).resolve().parent
        env = dict(os.environ, PYTHONPATH=str(here.parent),
                   OMP_NUM_THREADS="1")
        self.procs = [subprocess.Popen(
            [sys.executable, str(here / "_torch_dp_worker.py"), str(r),
             str(world), str(self.work)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(world)]

    def results(self):
        import subprocess
        outs = []
        try:
            for p in self.procs:
                log, _ = p.communicate(timeout=self.timeout)
                assert p.returncode == 0, log[-3000:]
        except subprocess.TimeoutExpired:
            for p in self.procs:
                p.kill()
                p.communicate()
            raise AssertionError("a data-parallel worker timed out")
        for r in range(len(self.procs)):
            with np.load(self.work / f"out_{r}.npz") as f:
                outs.append(dict(f))
        return outs


def dp_leaves(out, name, kind):
    """A scenario's recorded leaves ("params" or "state") from a worker's
    output, in ``leaves`` order."""
    n = sum(1 for k in out if k.startswith(f"{name}/{kind}/"))
    return [out[f"{name}/{kind}/{i}"] for i in range(n)]


def slab_mean(per_rank, weights):
    """The data-parallel combination written out: each rank's tensors
    flattened into one float32 vector with a 1 appended, times the rank's
    weight, summed over the ranks in order, divided by the summed weight
    (at least 1); returned as tensors shaped like rank 0's."""
    flats = [torch.cat([t.reshape(-1) for t in ts] + [torch.ones(1)])
             * torch.tensor(float(w)) for ts, w in zip(per_rank, weights)]
    total = flats[0]
    for f in flats[1:]:
        total = total + f
    mean = total[:-1] / torch.clamp(total[-1], min=1.0)
    out, offset = [], 0
    for t in per_rank[0]:
        out.append(mean[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return out


def dp_emulation(core, params, state, shards, weights, make_optimizer):
    """One data-parallel step emulated in this process: ``core`` (the
    port's gradient core) on each rank's shard from the same (params,
    state), the gradients, BN states and metrics combined by
    ``slab_mean``, then one step of ``make_optimizer(tensors)`` over a
    copy of ``params``.  Returns (params, state, metrics)."""
    from yolov4tpu_torch import train as ttrain
    per_rank, trees = [], None
    for shard in shards:
        g, st, m = core(params, state, shard)
        trees = (g, st, m)
        per_rank.append([t for p in (g, st, m) for t in ttrain.leaves(p)])
    means = iter(slab_mean(per_rank, weights))
    g, st, m = (ttrain.unflatten(p, means) for p in trees)
    new = ttrain.tree_map(lambda t: t.clone(), params)
    make_optimizer(ttrain.leaves(new)).step(ttrain.leaves(g))
    return new, st, m


def background(fn, *args):
    """Start ``fn(*args)`` in a thread (torch's kernels release the GIL, so
    it overlaps a JAX compile); returns a function that joins the thread
    and returns fn's result or raises its exception."""
    import threading
    box = {}

    def run():
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — raised in the caller
            box["err"] = e

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def result():
        t.join(timeout=300)
        if t.is_alive():
            raise AssertionError(f"{fn.__name__} did not finish in 300 s")
        if "err" in box:
            raise box["err"]
        return box["out"]

    return result
