"""Inference from one caller in a closed loop: it sends ``predict_batch``
a host uint8 batch from a seeded pool, waits for the detections on the
host, and sends the next.

The traffic file gives ``batch``, ``pool`` (distinct batches, cycled in
order), ``warmup_calls``, ``calibrate_images`` and ``density`` (boxes an
image that clear the score threshold after the head calibration),
``nms_impl`` and ``candidates`` (the port's NMS path and its candidate
count), ``check_calls`` (calls judged against the reference, drawn from
the seed; the first and the last always), ``ref_block`` (images a
reference forward takes at once) and ``trace_calls`` (calls a traced
window holds at most).

Readings for the limits of ``correct`` (``perfbench/readings.py``; the
benchmark's own runs take none): ``"control"`` judges, beside the
program, the reference computed in float8 (e4m3, ``lowp``), the precision
below the configuration's bfloat16, put in the program's place: its
decode and exact greedy NMS over the same candidate cut serve each judged
call; ``"int8"`` switches on the program's own int8 path
(``Yolov4.quantize``) and judges it in the program's place.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench.harness import env, weights
from perfbench.harness.runner import Run
from perfbench.harness.scene import scene
from perfbench.harness.trace import DeviceTrace, Spans, now_ns
from perfbench.reference import decode, judge_infer, lowp, nms, yolov4


def log(*parts):
    print(*parts, flush=True)


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
    log(env.card_line(device))
    # One caller thread: keep the host's intra-op pool from spinning
    # beside it.
    torch.set_num_threads(1)

    params, state = weights.make(env.sub_seed(seed, 0), side, ncls, device,
                                 depth)
    calib = scene(env.sub_seed(seed, 1), tr["calibrate_images"], side, side,
                  device)
    delta = weights.calibrate(
        params, state, torch.as_tensor(calib, device=device).float() / 255,
        ncls, cfg["score_threshold"], tr["density"], depth=depth)
    pool = scene(env.sub_seed(seed, 2), pool_n * b, side, side, device)
    batches = [pool[i * b:(i + 1) * b] for i in range(pool_n)]
    classes = env.write_classes(env.tmpdir(cell.name) / "classes.txt", ncls)
    log(f"weights seed {seed}: head shift {delta:.6f}; pool {pool_n} x "
        f"{b} of {side}x{side}")

    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    conf = YoloConfig(img_size=(side, side, 3), csp_repeats=depth,
                      compute_dtype=cfg["compute_dtype"],
                      nms_impl=tr["nms_impl"],
                      nms_pre_top_k=tr["candidates"],
                      max_boxes=cfg["max_boxes"],
                      iou_threshold=cfg["iou_threshold"],
                      score_threshold=cfg["score_threshold"])
    model = Yolov4(class_name_path=str(classes), config=conf, device=device)
    model.sync_params(params, state)
    if "int8" in variants:
        model.quantize(calib_imgs=calib.astype(np.float32) / 255.0)
        log("int8: the program's int8 path (quantize)")
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
    del model, out
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, work, looks = check(cell, seed, params, state, batches, calls,
                                served, device, count_work=trace,
                                control="control" in variants)
    return Run(calls=calls, window=window, first_call=start, checks=checks,
               attempted=len(calls) * b, failed=0, memory_peak=peak,
               device=env.device_info(device, peak), trace=dt, spans=spans,
               extra={"nms_work": work, "variants": looks})


def check(cell, seed, params, state, batches, calls, served, device,
          count_work=False, control=False):
    """Judge a sample of the window's calls against the reference; with
    ``count_work``, also count each pool batch's NMS work on the
    reference's own candidates; with ``control``, also judge the float8
    reference served in the program's place.  Returns (the numbers, the
    work, {"control": its numbers} or {})."""
    cfg, tr = cell.config, cell.traffic
    side, ncls = cfg["img_size"], cfg["num_classes"]
    depth = tuple(cfg["csp_repeats"])
    limits = (cfg["iou_threshold"], cfg["score_threshold"], cfg["max_boxes"],
              tr["candidates"])
    n = len(calls)
    rng = np.random.default_rng(env.sub_seed(seed, 3))
    picked = set(rng.choice(n, min(tr["check_calls"], n), replace=False)
                 .tolist()) | {0, n - 1}
    folded = yolov4.fold_bn(params, state)
    readings = judge_infer.Readings()
    ctrl = judge_infer.Readings()
    work = {}
    for k, batch in enumerate(batches):
        mine = [i for i in sorted(picked) if calls[i]["batch"] == k]
        if not mine and not count_work:
            continue
        (boxes, scores), yard = (reference(folded, batch, tr["ref_block"],
                                           ncls, side, depth, quant)
                                 for quant in (None, lowp.bf16))
        for i in mine:
            judge_infer.judge(boxes, scores, served[i], *limits, readings,
                              yard)
        if control and mine:
            low = reference(folded, batch, tr["ref_block"], ncls, side,
                            depth, lowp.fp8_e4m3)
            judge_infer.judge(boxes, scores, nms.serve(*low, *limits), *limits,
                              ctrl, yard)
        if count_work or control:
            work[k] = nms_work(boxes, scores, cfg, tr["candidates"])
    log(f"judged {len(picked)} of {n} calls")
    if work:
        log("NMS on the reference's candidates keeps {} of the {} pairs "
            "above the score threshold".format(
                *(sum(w[key] for w in work.values())
                  for key in ("kept", "above"))))
    looks = {"control": ctrl.numbers()} if control else {}
    return readings.numbers(), work, looks


def reference(folded, batch, block, ncls, side, depth, quant=None):
    """The reference's decode of a uint8 batch, ``block`` images at a
    time: boxes (B, N, 4) and scores (B, N, C) on the weights' device."""
    boxes, scores = [], []
    for s in range(0, len(batch), block):
        x = torch.as_tensor(batch[s:s + block],
                            device=folded[0][0].device).float() / 255
        bx, sc = decode.decode(yolov4.forward_folded(folded, x, ncls, quant,
                                                     depth), ncls, side)
        boxes.append(bx)
        scores.append(sc)
    return torch.cat(boxes), torch.cat(scores)


def nms_work(boxes, scores, cfg, candidates: int) -> dict:
    """The NMS problem of one batch on the reference's candidates (the
    ``candidates`` best anchors by best-class score, as the served path
    takes them): each candidate's box, score and class read once (24
    bytes) and its kept flag written (1 byte), and the IoU tests greedy
    NMS makes; besides, the pairs it keeps and those above the score
    threshold."""
    tests = kept = above = 0
    k = min(candidates, scores.shape[1])
    top = torch.topk(scores.amax(-1), k, dim=1).indices
    for i in range(len(boxes)):
        bx = boxes[i, top[i]].double().cpu().numpy()
        sc = scores[i, top[i]].double().cpu().numpy()
        pairs, t = nms.greedy(bx, sc, cfg["iou_threshold"],
                              cfg["score_threshold"])
        tests, kept = tests + t, kept + len(pairs)
        above += int((sc > cfg["score_threshold"]).sum())
    return {"bytes": len(boxes) * k * 25, "tests": tests, "kept": kept,
            "above": above}
