"""Seeded YOLOv4 weights, made on the device in a few large calls, in the
dictionaries both the program's public API and the reference take:
``{"convs": [{"w", "gamma", "beta"} | {"w", "b"}]}`` with OIHW kernels and
``{"bn": [{"mean", "var"} | None]}``, in darknet's serial order.  Kernels
are N(0, 1/fan_in), BatchNorm gamma U(0.8, 1.2), beta N(0, 0.1), mean
N(0, 0.1), var U(0.5, 1.5), head biases N(0, 0.1), as the smoke script's
random darknet weights.

``calibrate`` is a frozen copy of the port's
``weights.calibrate_detection_density`` (with ``spread``): it rescales the
heads' objectness and class logits to a standard deviation of ``spread``
and shifts them so that about ``target`` boxes an image clear the score
threshold, moved to the shift whose nearest score lies farthest from the
threshold.  It reads the reference's float32 forward."""

from __future__ import annotations

import numpy as np
import torch

from ..reference import topology, yolov4


def make(seed: int, side: int, num_classes: int, device, depth=topology.DEPTH):
    """(params, state) for the graph at ``side`` pixels."""
    layers = topology.conv_layers(side, num_classes, depth)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    sizes = [l.co * l.ci * l.k * l.k for l in layers]
    fan = torch.tensor([(l.ci * l.k * l.k) ** -0.5 for l in layers],
                       device=device)
    flat = torch.randn(sum(sizes), generator=g, device=device)
    flat.mul_(fan.repeat_interleave(torch.tensor(sizes, device=device)))
    n_bn = sum(l.co for l in layers if l.bn)
    n_head = sum(l.co for l in layers if not l.bn)
    u = torch.rand((2, n_bn), generator=g, device=device)
    n = torch.randn((2, n_bn), generator=g, device=device) * 0.1
    head = torch.randn(n_head, generator=g, device=device) * 0.1
    gamma, var = 0.8 + 0.4 * u[0], 0.5 + u[1]
    convs, bn = [], []
    o = ob = oh = 0
    for l, size in zip(layers, sizes):
        w = flat[o:o + size].view(l.co, l.ci, l.k, l.k)
        o += size
        if l.bn:
            s = slice(ob, ob + l.co)
            convs.append({"w": w, "gamma": gamma[s], "beta": n[0, s]})
            bn.append({"mean": n[1, s], "var": var[s]})
            ob += l.co
        else:
            convs.append({"w": w, "b": head[oh:oh + l.co]})
            bn.append(None)
            oh += l.co
    return {"convs": convs}, {"bn": bn}


def calibrate(params, state, images, num_classes: int, score_t: float,
              target: float, spread: float = 1.0, depth=topology.DEPTH):
    """Rescale and shift the heads' objectness and class logits in place
    (see the module's docstring).  images: (B, H, W, 3) float in [0, 1] on
    the weights' device."""
    raws = yolov4.forward_folded(yolov4.fold_bn(params, state), images,
                                 num_classes, depth=depth)
    obj, mcls = [], []
    for r in raws:
        flat = r.reshape(r.shape[0], -1, 5 + num_classes).double().cpu()
        obj.append(flat[..., 4].numpy())
        mcls.append(flat[..., 5:].amax(-1).numpy())
    obj, mcls = np.concatenate(obj, 1), np.concatenate(mcls, 1)
    n_img = obj.shape[0]
    mu_obj, mu_cls = float(obj.mean()), float(mcls.mean())
    k_obj = min(spread / max(float(obj.std()), 1e-6), 1e3)
    k_cls = min(spread / max(float(mcls.std()), 1e-6), 1e3)
    obj = k_obj * (obj - mu_obj) + mu_obj
    mcls = k_cls * (mcls - mu_cls) + mu_cls

    def scores(delta):
        return (1 / (1 + np.exp(-(obj + delta)))) * (1 / (1 + np.exp(
            -(mcls + delta))))

    def count(delta):
        return float((scores(delta) > score_t).sum()) / n_img

    lo, hi = -30.0, 30.0
    if count(lo) > target or count(hi) < target:
        raise ValueError("target density unreachable by a scalar bias shift")
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if count(mid) < target else (lo, mid)
    delta, best = 0.5 * (lo + hi), None
    for off in np.linspace(-0.1, 0.1, 201):
        s = scores(delta + off)
        c = float((s > score_t).sum()) / n_img
        if 0.5 * target <= c <= 1.5 * target:
            margin = float(np.abs(s - score_t).min())
            if best is None or margin > best[0]:
                best = (margin, delta + off)
    delta = best[1] if best is not None else delta
    with torch.no_grad():
        for p in params["convs"]:
            if "b" not in p:
                continue
            b = p["b"].view(3, 5 + num_classes)
            w = p["w"].view(3, 5 + num_classes, -1)
            b[:, 4] = k_obj * b[:, 4] + (1 - k_obj) * mu_obj + delta
            b[:, 5:] = k_cls * b[:, 5:] + (1 - k_cls) * mu_cls + delta
            w[:, 4] *= k_obj
            w[:, 5:] *= k_cls
    return delta
