"""Inference of YOLOv4-P6 (Scaled-YOLOv4) from one caller in a closed
loop: it sends ``predict_batch`` a host uint8 batch from a seeded pool,
waits for the detections on the host, and sends the next.

The traffic file gives what ``loops/infer.py``'s does: ``batch``,
``pool``, ``warmup_calls``, ``calibrate_images``, ``density``,
``nms_impl``, ``candidates``, ``check_calls``, ``ref_block`` and
``trace_calls``.  The configuration gives the graph (``arch``,
``csp_repeats``), the anchors, strides and thresholds.  Weights come from
the P6 reference's seeded maker (``reference.scaled_yolov4.make``), the
heads calibrated on its float32 forward (``calibrate``); each judged call
is held against that reference (BN unfolded, the Detect's decode) by
``judge_infer``, as the YOLOv4 cells are; with ``--trace 1`` the NMS
work of each pool batch is counted on the reference's candidates.

Besides ``judge_infer``'s numbers, ``grid_ratio``: the mean |program -
reference| over every value of the four raw head grids of the judged
pool batches, over the same mean of the reference computed in bfloat16
(``lowp.bf16``): how far the forward's rounding exceeds what its
precision gives.  Its grids come from the facade's own forward
(``Yolov4._raw``, the function ``predict_batch`` runs) on the same
batches after the window.  The detections' own ratio (``det_ratio``)
swings from seed to seed at P6's size: a detection is paired with the
nearest of ~136,000 anchors, many of them boxes that reach past the
image and clip alike, so the pairing hides more on some seeds than on
others; the grids are compared value for value.

Readings for the limits of ``correct`` (``perfbench/readings.py``):
``"control"`` judges, beside the program, the reference computed in
float8 (e4m3, ``lowp``; mish's temporaries in float32, as
``scaled_yolov4`` says) put in the program's place, its grids and its
detections.
"""

from __future__ import annotations

import gc
from pathlib import Path

import numpy as np
import torch

from perfbench.harness import env, manifest
from perfbench.harness.runner import Run
from perfbench.harness.scene import scene
from perfbench.harness.trace import DeviceTrace, Spans, now_ns
from perfbench.reference import judge_infer, lowp, nms
from perfbench.reference import scaled_yolov4 as p6


def log(*parts):
    print(*parts, flush=True)


def _nms_work():
    return manifest.load_module(Path(__file__).with_name("infer.py"),
                                "loop_infer").nms_work


def calibrate(params, state, images, num_classes: int, score_t: float,
              target: float, depth, spread: float = 1.0):
    """Rescale the heads' objectness and class logits to a standard
    deviation of ``spread`` and shift them so that about ``target`` boxes
    an image clear ``score_t``, moved to the shift whose nearest score lies
    farthest from the threshold (the YOLOv4 cells' calibration,
    ``harness/weights.py``, on P6's four anchors a cell); in place.
    images: (B, H, W, 3) float in [0, 1] on the weights' device.  Returns
    the shift."""
    raws = p6.forward(params, state, images, num_classes, depth=depth)
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
            na = p["b"].shape[0] // (5 + num_classes)
            b = p["b"].view(na, 5 + num_classes)
            w = p["w"].view(na, 5 + num_classes, -1)
            b[:, 4] = k_obj * b[:, 4] + (1 - k_obj) * mu_obj + delta
            b[:, 5:] = k_cls * b[:, 5:] + (1 - k_cls) * mu_cls + delta
            w[:, 4] *= k_obj
            w[:, 5:] *= k_cls
    return delta


def run(cell, seed: int, seconds: float, trace: bool, device,
        variants=()) -> Run:
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import YoloConfig
    from yolov4tpu_torch.ops import nms_cuda

    cfg, tr = cell.config, cell.traffic
    side, ncls = cfg["img_size"], cfg["num_classes"]
    depth = tuple(cfg["csp_repeats"])
    b, pool_n = tr["batch"], tr["pool"]
    cuda = str(device) != "cpu"
    # The configuration first: a program without this architecture fails
    # here, before any work.
    conf = YoloConfig(arch=cfg["arch"], img_size=(side, side, 3),
                      anchors=tuple(cfg["anchors"]),
                      strides=tuple(cfg["strides"]),
                      xyscale=tuple(cfg["xyscale"]), csp_repeats=depth,
                      compute_dtype=cfg["compute_dtype"],
                      nms_impl=tr["nms_impl"],
                      nms_pre_top_k=tr["candidates"],
                      max_boxes=cfg["max_boxes"],
                      iou_threshold=cfg["iou_threshold"],
                      score_threshold=cfg["score_threshold"])
    log(env.card_line(device))
    torch.set_num_threads(1)

    params, state = p6.make(env.sub_seed(seed, 0), ncls, device, depth)
    calib = scene(env.sub_seed(seed, 1), tr["calibrate_images"], side, side,
                  device)
    delta = calibrate(params, state,
                      torch.as_tensor(calib, device=device).float() / 255,
                      ncls, cfg["score_threshold"], tr["density"], depth)
    pool = scene(env.sub_seed(seed, 2), pool_n * b, side, side, device)
    # Each batch a numpy array of its own, as numpy allocates a caller's
    # batch (``scene`` hands over memory of torch's allocator).
    batches = [np.array(pool[i * b:(i + 1) * b]) for i in range(pool_n)]
    del pool
    classes = env.write_classes(env.tmpdir(cell.name) / "classes.txt", ncls)
    log(f"weights seed {seed}: head shift {delta:.6f}; pool {pool_n} x "
        f"{b} of {side}x{side}")

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    model = Yolov4(class_name_path=str(classes), config=conf, device=device)
    model.sync_params(params, state)
    for i in range(tr["warmup_calls"]):
        [o.cpu() for o in model.predict_batch(batches[i % pool_n])]

    launches = nms_cuda.LAUNCHES
    spans, dt = Spans(), (DeviceTrace(device) if trace else None)
    if dt is not None:
        dt.start()
    limit = tr["trace_calls"] if trace else None
    calls, served = [], []
    start = now_ns()
    while True:
        i = len(calls)
        k = i % pool_n
        t0 = now_ns()
        out = model.predict_batch(batches[k])
        t1 = now_ns()
        host = tuple(o.cpu().numpy() for o in out)
        t2 = now_ns()
        spans.add("predict_batch", t0, t1, i)
        spans.add("fetch", t1, t2, i)
        calls.append({"start": t0, "end": t2, "images": b, "batch": k})
        served.append(host)
        if t2 - start >= seconds * 1e9 or (limit and len(calls) >= limit):
            break
    window = (start, calls[-1]["end"])
    if dt is not None:
        dt.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f"window: {len(calls)} calls, {nms_cuda.LAUNCHES - launches} "
        f"suppress_rank launches")
    grids = [model._raw(torch.as_tensor(x, device=device).float() / 255.0)
             for x in batches]
    del model, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, work, looks = check(cell, seed, params, state, batches, calls,
                                served, grids, count_work=trace,
                                control="control" in variants)
    return Run(calls=calls, window=window, first_call=start, checks=checks,
               attempted=len(calls) * b, failed=0, memory_peak=peak,
               device=env.device_info(device, peak), trace=dt, spans=spans,
               extra={"nms_work": work, "variants": looks})


def check(cell, seed, params, state, batches, calls, served, grids,
          count_work=False, control=False):
    """Judge a sample of the window's calls against the reference, and
    the program's raw grids of each pool batch (``grids``) of the calls
    judged; with ``count_work``, also count each pool batch's NMS work on
    the reference's own candidates; with ``control``, also judge the
    float8 reference served in the program's place.  Returns (the
    numbers, the work, {"control": its numbers} or {})."""
    cfg, tr = cell.config, cell.traffic
    ncls = cfg["num_classes"]
    limits = (cfg["iou_threshold"], cfg["score_threshold"], cfg["max_boxes"],
              tr["candidates"])
    n = len(calls)
    rng = np.random.default_rng(env.sub_seed(seed, 3))
    picked = set(rng.choice(n, min(tr["check_calls"], n), replace=False)
                 .tolist()) | {0, n - 1}
    readings = judge_infer.Readings()
    ctrl = judge_infer.Readings()
    work, err = {}, np.zeros(3)  # grid error: program, bf16, float8
    nms_work = _nms_work()
    for k, batch in enumerate(batches):
        mine = [i for i in sorted(picked) if calls[i]["batch"] == k]
        if not mine and not count_work:
            continue
        (boxes, scores, ref), (*yard, yard_raw) = (
            reference(params, state, batch, cell, quant)
            for quant in (None, lowp.bf16))
        for i in mine:
            judge_infer.judge(boxes, scores, served[i], *limits, readings,
                              yard)
        if mine:
            err[:2] += grid_error(grids[k], ref), grid_error(yard_raw, ref)
        if control and mine:
            *low, low_raw = reference(params, state, batch, cell,
                                      lowp.fp8_e4m3, mish_steps=False)
            judge_infer.judge(boxes, scores, nms.serve(*low, *limits), *limits,
                              ctrl, yard)
            err[2] += grid_error(low_raw, ref)
        if count_work or control:
            work[k] = nms_work(boxes, scores, cfg, tr["candidates"])
    log(f"judged {len(picked)} of {n} calls")
    if work:
        log("NMS on the reference's candidates keeps {} of the {} pairs "
            "above the score threshold".format(
                *(sum(w[key] for w in work.values())
                  for key in ("kept", "above"))))
    ratio = err / err[1] if err[1] else np.full(3, np.inf)
    looks = ({"control": dict(ctrl.numbers(), grid_ratio=float(ratio[2]))}
             if control else {})
    return dict(readings.numbers(), grid_ratio=float(ratio[0])), work, looks


def grid_error(grids, ref) -> float:
    """The sum of |grids - ref| over every value of the four raw grids."""
    return float(sum((g.double() - r.double()).abs().sum()
                     for g, r in zip(grids, ref)))


def reference(params, state, batch, cell, quant=None, mish_steps=True):
    """The reference's decode of a uint8 batch, ``ref_block`` images at a
    time: boxes (B, N, 4), scores (B, N, C) and the four raw grids, on the
    weights' device."""
    cfg = cell.config
    ncls, side = cfg["num_classes"], cfg["img_size"]
    depth, block = tuple(cfg["csp_repeats"]), cell.traffic["ref_block"]
    anchors = np.asarray(cfg["anchors"]).reshape(len(cfg["strides"]), -1, 2)
    boxes, scores, raws = [], [], []
    for s in range(0, len(batch), block):
        x = torch.as_tensor(batch[s:s + block],
                            device=params["convs"][0]["w"].device) / 255.0
        raw = p6.forward(params, state, x, ncls, quant, depth, mish_steps)
        bx, sc = p6.decode(raw, ncls, side, anchors.tolist(), cfg["strides"])
        boxes.append(bx)
        scores.append(sc)
        raws.append(raw)
    return (torch.cat(boxes), torch.cat(scores),
            [torch.cat(g) for g in zip(*raws)])
