"""Darknet ``.weights`` import/export <-> the port's parameter dictionaries.

Byte layout (reference utils.py:12-53):

  header: 5 x int32 [major, minor, revision, seen, _]
  then, for each of the 110 conv layers in serial (creation) order:
    - BN layers: 4*filters float32 in darknet order [beta, gamma, mean, var]
    - bias layers (the three head convs): filters float32
    - conv kernel: filters*in_ch*k*k float32 in (out, in, h, w) order

The layout table comes from the port's own topology trace
(``models.network.conv_specs``).  Darknet's kernel order is PyTorch's OIHW,
so kernels load without a transpose.  Also the reader of reference-era
keras ``.h5`` weight files (``load_keras_h5``), and the synthetic-weight
helpers the tests and ``chip_smoke.py`` use to make a random detector emit
a realistic number of boxes.
"""

from __future__ import annotations

import io
from typing import BinaryIO, Tuple

import numpy as np
import torch

from .models.network import conv_specs


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _read(f: BinaryIO, count: int) -> np.ndarray:
    buf = f.read(count * 4)
    if len(buf) != count * 4:
        raise ValueError(
            f"truncated .weights file: wanted {count} floats, got {len(buf) // 4}")
    return np.frombuffer(buf, dtype=np.float32, count=count)


def load_darknet_weights(path_or_file, num_classes: int,
                         strict: bool = True) -> Tuple[dict, dict]:
    """Parse a darknet .weights file into (params, state) dictionaries of
    CPU float32 tensors.  BN [beta,gamma,mean,var] -> gamma/beta/mean/var.
    With strict=True, raises if the file is not fully consumed."""
    if hasattr(path_or_file, "read"):
        f, close = path_or_file, False
    else:
        f, close = open(path_or_file, "rb"), True
    try:
        header = np.frombuffer(f.read(5 * 4), dtype=np.int32, count=5)
        if len(header) != 5:
            raise ValueError("truncated .weights header")

        convs, bn_state = [], []
        for spec in conv_specs(num_classes):
            p = {}
            if spec.batch_norm:
                bn = _read(f, 4 * spec.filters).reshape(4, spec.filters)
                p["gamma"] = torch.from_numpy(bn[1].copy())
                p["beta"] = torch.from_numpy(bn[0].copy())
                bn_state.append({"mean": torch.from_numpy(bn[2].copy()),
                                 "var": torch.from_numpy(bn[3].copy())})
            else:
                p["b"] = torch.from_numpy(_read(f, spec.filters).copy())
                bn_state.append(None)
            k, cin, cout = spec.kernel_size, spec.in_ch, spec.filters
            p["w"] = torch.from_numpy(
                _read(f, cout * cin * k * k).reshape(cout, cin, k, k).copy())
            convs.append(p)

        remainder = f.read()
        if strict and remainder:
            raise ValueError(
                f".weights file not fully consumed: {len(remainder)} bytes left "
                f"(wrong num_classes?)")
    finally:
        if close:
            f.close()
    return {"convs": convs}, {"bn": bn_state}


def save_darknet_weights(params: dict, state: dict, path,
                         header=(0, 2, 5, 0, 0)) -> None:
    """Serialise (params, state) back to darknet .weights byte layout."""
    with open(path, "wb") as f:
        np.asarray(header, dtype=np.int32).tofile(f)
        for p, bn in zip(params["convs"], state["bn"]):
            if bn is not None:
                np.stack([_numpy(p["beta"]), _numpy(p["gamma"]),
                          _numpy(bn["mean"]), _numpy(bn["var"])]).tofile(f)
            else:
                _numpy(p["b"]).tofile(f)
            _numpy(p["w"]).tofile(f)  # already (out, in, h, w)


def load_keras_h5(path: str, num_classes: int) -> Tuple[dict, dict]:
    """Reader for reference-era keras ``.h5`` weight files -> (params,
    state) dictionaries of CPU float32 tensors (OIHW kernels).

    Reads both legacy keras HDF5 layouts (``save_weights`` files and
    full-model saves with a ``model_weights`` group) by the auto-name
    scheme of the reference's loader (``conv2d``/``conv2d_{i}`` with a
    separate ``batch_normalization_{j}`` counter, reference
    utils.py:19-24), as ``yolov4tpu.weights.load_keras_h5`` does.  h5py is
    imported here only: nothing else of the port needs it.
    """
    import h5py

    def names(group):
        return [n.decode() if isinstance(n, bytes) else n
                for n in group.attrs["weight_names"]]

    def arrays(group):
        return {n.rsplit("/", 1)[-1].split(":")[0]: np.asarray(group[n])
                for n in names(group)}

    def tensor(a):
        return torch.from_numpy(np.array(a, np.float32))

    with h5py.File(path, "r") as f:
        g = f["model_weights"] if "model_weights" in f else f
        convs, bn_state = [], []
        bn_idx = 0
        for i, spec in enumerate(conv_specs(num_classes)):
            cname = f"conv2d_{i}" if i > 0 else "conv2d"
            carr = arrays(g[cname])
            kernel = carr["kernel"]
            if kernel.shape != (spec.kernel_size, spec.kernel_size,
                                spec.in_ch, spec.filters):
                raise ValueError(
                    f"{cname}: kernel shape {kernel.shape} does not match "
                    f"spec {spec} (wrong num_classes?)")
            p = {"w": tensor(kernel.transpose(3, 2, 0, 1))}  # HWIO -> OIHW
            if spec.batch_norm:
                bname = (f"batch_normalization_{bn_idx}" if bn_idx > 0
                         else "batch_normalization")
                barr = arrays(g[bname])
                p["gamma"] = tensor(barr["gamma"])
                p["beta"] = tensor(barr["beta"])
                bn_state.append({"mean": tensor(barr["moving_mean"]),
                                 "var": tensor(barr["moving_variance"])})
                bn_idx += 1
            else:
                p["b"] = tensor(carr["bias"])
                bn_state.append(None)
            convs.append(p)
    return {"convs": convs}, {"bn": bn_state}


def random_darknet_bytes(num_classes: int, seed: int = 0) -> bytes:
    """A synthetic, correctly-sized .weights byte stream (for tests and the
    chip smoke run): positive BN variance, ~unit-gain kernels, so a network
    loaded from it computes finite, comparable activations.  Byte-equal to
    ``yolov4tpu.weights.random_darknet_bytes`` for the same seed."""
    rng = np.random.default_rng(seed)
    out = io.BytesIO()
    out.write(np.asarray([0, 2, 5, 0, 0], dtype=np.int32).tobytes())
    for spec in conv_specs(num_classes):
        f = spec.filters
        if spec.batch_norm:
            beta = rng.normal(0.0, 0.1, f)
            gamma = rng.uniform(0.8, 1.2, f)
            mean = rng.normal(0.0, 0.1, f)
            var = rng.uniform(0.5, 1.5, f)
            out.write(np.concatenate([beta, gamma, mean, var])
                      .astype(np.float32).tobytes())
        else:
            out.write(rng.normal(0.0, 0.1, f).astype(np.float32).tobytes())
        k = spec.kernel_size
        fan_in = k * k * spec.in_ch
        w = rng.normal(0.0, 1.0 / np.sqrt(fan_in), f * spec.in_ch * k * k)
        out.write(w.astype(np.float32).tobytes())
    return out.getvalue()


def calibrate_detection_density(params: dict, raw_outputs, num_classes: int,
                                score_threshold: float = 0.3,
                                target_per_image: float = 120.0,
                                spread: float = None):
    """Shift the head-conv obj/class biases so a random-init detector emits
    ~``target_per_image`` boxes whose best-class score clears
    ``score_threshold``.

    The head convs are the last layer with no BN and no activation, so
    adding ``delta`` to their obj/class biases shifts those logits by exactly
    ``delta``; delta is found by bisection on ``raw_outputs`` (NHWC grids the
    current params produced), then moved to the nearby value whose nearest
    score is farthest from the threshold, so tiny numeric differences cannot
    flip a box across it.

    spread: also rescale the obj/class logit distributions to this standard
    deviation (``w' = k*w, b' = k*b+(1-k)*mean``), so the density survives
    bf16 re-forwarding.  Returns ``(new_params, delta)``; new_params has
    copied head convs.
    """
    obj_logits, cls_logits = [], []
    for raw in raw_outputs:
        r = _numpy(raw)
        flat = r.reshape(r.shape[0], -1, 5 + num_classes)
        obj_logits.append(flat[..., 4])
        cls_logits.append(flat[..., 5:].max(-1))
    obj = np.concatenate(obj_logits, axis=1)
    mcls = np.concatenate(cls_logits, axis=1)
    n_img = obj.shape[0]

    k_obj = k_cls = 1.0
    mu_obj = mu_cls = 0.0
    if spread is not None:
        mu_obj, mu_cls = float(obj.mean()), float(mcls.mean())
        k_obj = min(spread / max(float(obj.std()), 1e-6), 1e3)
        k_cls = min(spread / max(float(mcls.std()), 1e-6), 1e3)
        obj = k_obj * (obj - mu_obj) + mu_obj
        mcls = k_cls * (mcls - mu_cls) + mu_cls

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    def count(delta):
        s = sigmoid(obj + delta) * sigmoid(mcls + delta)
        return float((s > score_threshold).sum()) / n_img

    lo, hi = -30.0, 30.0
    if count(lo) > target_per_image or count(hi) < target_per_image:
        raise ValueError("target density unreachable by a scalar bias shift")
    for _ in range(60):  # monotone in delta -> plain bisection
        mid = 0.5 * (lo + hi)
        if count(mid) < target_per_image:
            lo = mid
        else:
            hi = mid
    delta = 0.5 * (lo + hi)

    best = None
    for off in np.linspace(-0.1, 0.1, 201):
        d = delta + off
        s = sigmoid(obj + d) * sigmoid(mcls + d)
        c = float((s > score_threshold).sum()) / n_img
        if not (0.5 * target_per_image <= c <= 1.5 * target_per_image):
            continue
        margin = float(np.abs(s - score_threshold).min())
        if best is None or margin > best[0]:
            best = (margin, d)
    delta = best[1] if best is not None else delta

    new_convs = []
    for p in params["convs"]:
        p = dict(p)
        if "b" in p:
            b = _numpy(p["b"]).copy().reshape(3, 5 + num_classes)
            b[:, 4] = k_obj * b[:, 4] + (1 - k_obj) * mu_obj + delta
            b[:, 5:] = k_cls * b[:, 5:] + (1 - k_cls) * mu_cls + delta
            p["b"] = torch.from_numpy(b.ravel())
            if spread is not None:
                w = _numpy(p["w"]).copy()                 # OIHW
                wr = w.reshape(3, 5 + num_classes, *w.shape[1:])
                wr[:, 4] *= k_obj
                wr[:, 5:] *= k_cls
                p["w"] = torch.from_numpy(wr.reshape(w.shape))
        new_convs.append(p)
    return {**params, "convs": new_convs}, delta


def force_busy_heads(params: dict, num_classes: int,
                     hot=((2, 0, 0), (2, 1, 1)),
                     on_logit: float = 2.0, off_logit: float = -6.0):
    """Overwrite head-conv obj/class biases so chosen channels fire at every
    grid cell: a deterministic busy scene whose hot cells all score exactly
    the same.

    Each ``(head, anchor, cls)`` in ``hot`` (head 0/1/2 = the three head
    convs in serial order) gets obj and that class's bias ``on_logit``;
    everything else gets ``off_logit``.  Entries may be 4-tuples
    ``(head, anchor, cls, logit)`` to give each channel its own logit.
    Returns new params (copied head convs).
    """
    new_convs, head_i = [], 0
    for p in params["convs"]:
        p = dict(p)
        if "b" in p:
            b = _numpy(p["b"]).copy().reshape(3, 5 + num_classes)
            b[:, 4:] = off_logit
            for entry in hot:
                h, anchor, cls = entry[0], entry[1], entry[2]
                logit = entry[3] if len(entry) > 3 else on_logit
                if h == head_i:
                    # obj bias: the strongest of this channel's hot classes.
                    b[anchor, 4] = max(b[anchor, 4], logit) \
                        if b[anchor, 4] > off_logit else logit
                    b[anchor, 5 + cls] = logit
            p["b"] = torch.from_numpy(b.ravel())
            head_i += 1
        new_convs.append(p)
    return {**params, "convs": new_convs}
