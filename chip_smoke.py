"""Smoke run of the PyTorch/CUDA port (yolov4tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. the card (name and power limit, as nvidia-smi reports them) and the
     build of every CUDA kernel from the sources in the checkout;
  2. each kernel against its plain PyTorch version at the main path's
     shapes (B=8, C=80, K=256, and K=100): random and tie-heavy scores, a
     per-class cap that bites, an all-empty image — results exactly equal;
  3. the main path through the user's entry points: ``Yolov4`` at full
     depth, 416x416, COCO-80, random darknet weights from a seed with the
     head biases calibrated to ~120 boxes per image, ``predict_batch`` at
     batch 8 in float32 and bfloat16 on float and uint8 input.  Launch
     counts are zeroed just before and read just after.  Then: the kernel
     NMS tail equals the plain tail on the same raw grids, float32 on the
     card (TF32 off) matches the port on the CPU within 1e-3 per box,
     ``predict()`` on a written JPEG returns a DataFrame, and the bfloat16
     throughput at batch 8 and 64.

The line before the last is one JSON object with each kernel's launches,
error against its plain version, times and bound; the last line is
``{"ok": true, "device": {...}}``.  Needs CUDA: without it the script exits
with status 1 at once.
"""

from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
CLASSES = ROOT / "class_names" / "coco_classes.txt"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# float32 operations of one IoU test against a pivot: 2 min, 2 max, 2 sub,
# 2 clamps, the product, the union's add and sub, the divide, the compare.
IOU_OPS = 13


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str):
    if not cond:
        raise SmokeFailure(msg)


def log(*parts):
    print(*parts, flush=True)


def scene(seed: int, batch: int, size: int = 416) -> np.ndarray:
    """(B, size, size, 3) uint8 rasters: smooth blocks plus noise."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0, 255, (batch, size // 16, size // 16, 3))
    smooth = np.repeat(np.repeat(coarse, 16, axis=1), 16, axis=2)
    return np.clip(smooth + rng.normal(0, 25, smooth.shape), 0,
                   255).astype(np.uint8)


def cuda_ms(fn, n: int, repeats: int = 5, warmup: int = 2) -> float:
    """Median over ``repeats`` of the mean time of ``n`` calls, in ms, from
    CUDA events around the calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def suppress_bound_ms(coords, sc, rank, keep, score_threshold: float):
    """The least time the card could take for one suppression call on these
    inputs: each input read once and the output written once at the HBM
    rate, or the IoU tests these inputs need (every pivot rank i below the
    class's valid count against every candidate ranked after it) at the
    float32 rate, whichever is larger.  Returns (ms, "bytes"|"operations")."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (coords, sc, rank, keep))
    k = sc.shape[-1]
    n = (sc > score_threshold).sum(-1).double()          # valid per class
    tests = float((n * (k - 1) - n * (n - 1) / 2).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = tests * IOU_OPS / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def synthetic_candidates(rng, b, k, c, kind):
    """Candidate boxes (B, K, 4) clustered so many overlap, some with
    swapped corners, and scores (B, K, C) of the given kind."""
    n = b * k
    centers = rng.uniform(0.2, 0.8, (max(n // 6, 1), 2))
    xy = centers[rng.integers(0, len(centers), n)] + rng.normal(0, 0.02,
                                                                (n, 2))
    wh = rng.uniform(0.05, 0.25, (n, 2))
    boxes = np.concatenate([xy - wh / 2, xy + wh / 2], -1)
    swap = rng.uniform(size=n) < 0.1
    boxes[swap] = boxes[swap][:, [2, 3, 0, 1]]
    scores = rng.uniform(0, 1, (b, k, c))
    if kind == "ties":
        scores = np.round(scores / 0.05) * 0.05
    elif kind == "empty":
        scores[0] *= 0.25          # nothing clears 0.3 on image 0
    return (np.clip(boxes, 0, 1).astype(np.float32).reshape(b, k, 4),
            scores.astype(np.float32))


def match_detections(a, b, tol: float) -> float:
    """One image's detections from two runs, each (boxes (T,4), scores (T,),
    classes (T,), n): equal counts, and every detection of ``a`` paired
    with a distinct one of ``b`` of the same class whose box and score are
    within ``tol`` (order-free, so two near-equal scores may swap).
    Returns the largest deviation of the pairs."""
    (ab, as_, ac, an), (bb, bs, bc, bn) = a, b
    check(an == bn, f"valid counts differ: {an} vs {bn}")
    free = list(range(bn))
    worst = 0.0
    for i in range(an):
        dev = [max(np.abs(ab[i] - bb[j]).max(), abs(as_[i] - bs[j]))
               if ac[i] == bc[j] else np.inf for j in free]
        j = int(np.argmin(dev)) if dev else -1
        check(j >= 0 and dev[j] <= tol,
              f"detection {i} (class {ac[i]}) has no partner within {tol}")
        worst = max(worst, float(dev[j]))
        free.pop(j)
    return worst


def numpy_outputs(out, i: int):
    boxes, scores, classes, valid = (o.float().cpu().numpy() for o in out)
    n = int(valid[i])
    return boxes[i, :n], scores[i, :n], classes[i, :n], n


def kernel_phase(torch, nms_cuda):
    """Phase 2: the suppression kernel against its plain version."""
    rng = np.random.default_rng(0)
    worst = 0.0
    cases = [("random", 8, 256, 100), ("ties", 8, 256, 100),
             ("ties", 8, 256, 3), ("empty", 8, 256, 100),
             ("random", 8, 100, 100)]
    for kind, b, k, cap in cases:
        boxes, scores = synthetic_candidates(rng, b, k, 80, kind)
        coords, sc, rank = nms_cuda.rank_inputs(
            torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda())
        got = nms_cuda.suppress_rank(coords, sc, rank, 0.413, 0.3, cap)
        torch.cuda.synchronize()
        want = nms_cuda.suppress_rank_reference(coords, sc, rank, 0.413, 0.3,
                                                cap)
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"kernel != plain version ({kind}, K={k}, cap={cap}): "
              f"{int((got != want).sum())} entries differ")
        if kind == "empty":
            check(not got[0].any(), "the empty image kept a box")
        check(int(got.sum(-1).max()) <= cap, "the per-class cap was exceeded")
        worst = max(worst, err)
        log(f"kernel vs plain: {kind} B={b} C=80 K={k} cap={cap}: "
            f"{int(got.sum())} kept, equal (max abs err {err})")
    return worst


def nms_inputs(torch, nms_cuda, model, images):
    """The forward, the candidate decode and the rank sorts of the main path
    on device ``images`` (B, H, W, 3) float in [0, 1]: returns the stages'
    outputs, ending with the suppression kernel's arguments."""
    from yolov4tpu_torch.ops.detect import select_candidates
    cfg = model.config
    with torch.inference_mode():
        raws = model._raw(images)
        boxes, scores = select_candidates(
            raws, cfg.anchors_grouped, model.num_classes, cfg.strides,
            cfg.xyscale, cfg.img_size[0], cfg.nms_pre_top_k)
        coords, sc, rank = nms_cuda.rank_inputs(boxes, scores)
    return raws, boxes, scores, (coords, sc, rank, cfg.iou_threshold,
                                 cfg.score_threshold, cfg.max_boxes)


def time_stages(torch, nms_cuda, model, imgs_u8, label):
    """Each stage of predict_batch timed alone on the main path's inputs
    (CUDA events around repeated calls; eager stages include their host
    time), and the kernel against its plain version and its bound."""
    from yolov4tpu_torch.ops.detect import select_candidates
    cfg = model.config
    host = torch.from_numpy(imgs_u8)
    images = host.cuda().float() / 255.0
    raws, boxes, scores, args = nms_inputs(torch, nms_cuda, model, images)
    coords, sc, rank = args[:3]
    with torch.inference_mode():
        keep = nms_cuda.suppress_rank(*args)
        want = nms_cuda.suppress_rank_reference(*args)
        err = float((keep - want).abs().max())
        check(torch.equal(keep, want), f"kernel != plain version ({label})")
        stages = {
            "upload uint8": cuda_ms(lambda: host.cuda(), n=5),
            "forward": cuda_ms(lambda: model._raw(images), n=3),
            "candidates": cuda_ms(lambda: select_candidates(
                raws, cfg.anchors_grouped, model.num_classes, cfg.strides,
                cfg.xyscale, cfg.img_size[0], cfg.nms_pre_top_k), n=10),
            "rank sorts": cuda_ms(
                lambda: nms_cuda.rank_inputs(boxes, scores), n=10),
            "suppress kernel": cuda_ms(
                lambda: nms_cuda.suppress_rank(*args), n=50),
            "merge": cuda_ms(lambda: nms_cuda.merge(
                keep, sc, boxes, cfg.max_boxes, True), n=10),
        }
        plain_ms = cuda_ms(lambda: nms_cuda.suppress_rank_reference(*args),
                           n=1, repeats=3, warmup=1)
    bound, bound_by = suppress_bound_ms(coords, sc, rank, keep,
                                        cfg.score_threshold)
    nvalid = (sc > cfg.score_threshold).sum(-1)
    ms = stages["suppress kernel"]
    log(f"suppress_rank {label}: shape {tuple(sc.shape)}, valid per class "
        f"max {int(nvalid.max())} mean {float(nvalid.float().mean()):.2f}: "
        f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.6f} ms "
        f"({bound_by})")
    log(f"stages {label} (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                max_abs_err=err)


def predict_rate(torch, model, imgs_u8, iters: int = 10) -> float:
    """predict_batch images/s on host uint8 input, host clock around calls
    that end in a synchronize."""
    for _ in range(2):
        model.predict_batch(imgs_u8)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        model.predict_batch(imgs_u8)
    torch.cuda.synchronize()
    return iters * len(imgs_u8) / (time.perf_counter() - t0)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    import dataclasses

    import cv2

    from yolov4tpu_torch import weights
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.ops import nms_cuda

    # Every float32 comparison below runs in full float32: cuDNN would
    # otherwise run float32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # --- 1. card and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    so = nms_cuda.build()
    log(f"built {so.name} in {time.perf_counter() - t0:.1f} s")
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")

    # --- 2. kernel vs plain version --------------------------------------
    worst = kernel_phase(torch, nms_cuda)

    # --- 3. the main path ------------------------------------------------
    SCRATCH.mkdir(parents=True, exist_ok=True)
    wpath = SCRATCH / "random80.weights"
    wpath.write_bytes(weights.random_darknet_bytes(80, seed=0))
    m32 = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES))
    check(m32.device.type == "cuda", "the model is not on the card")
    u8 = scene(1, 8)
    f32 = u8.astype(np.float32) / 255.0
    with torch.inference_mode():
        raws = m32._raw(torch.from_numpy(f32).cuda())
    params, delta = weights.calibrate_detection_density(
        m32.params, raws, 80, spread=1.0)
    m32.sync_params(params, m32.state)
    m16 = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES),
                 config=dataclasses.replace(DEFAULT_CONFIG,
                                            compute_dtype="bfloat16"))
    m16.sync_params(params, m16.state)
    side = m32.config.img_size[0]
    log(f"model: {len(params['convs'])} convs, {side}x{side}, 80 classes, "
        f"calibrated delta {delta:.4f}")

    nms_cuda.LAUNCHES = 0
    outs = {"f32 float": m32.predict_batch(f32),
            "f32 uint8": m32.predict_batch(u8),
            "bf16 float": m16.predict_batch(f32),
            "bf16 uint8": m16.predict_batch(u8)}
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    check(launches >= len(outs), f"suppress_rank launched {launches} times "
          f"in {len(outs)} predict_batch calls")
    log(f"main path: {len(outs)} predict_batch calls at b8, suppress_rank "
        f"launched {launches} times")
    for name, out in outs.items():
        boxes, scores, classes, valid = out
        check(tuple(boxes.shape) == (8, 100, 4) and boxes.is_cuda,
              f"{name}: boxes {tuple(boxes.shape)} on {boxes.device}")
        check(all(bool(torch.isfinite(o.float()).all()) for o in out),
              f"{name}: non-finite outputs")
        check(float(boxes.min()) >= 0 and float(boxes.max()) <= 1,
              f"{name}: boxes outside [0, 1]")
        check(int(valid.min()) > 0, f"{name}: an image has no detections "
              f"({valid.tolist()})")
        log(f"{name}: valid detections {valid.tolist()}")
    for i in range(8):
        match_detections(numpy_outputs(outs["f32 float"], i),
                         numpy_outputs(outs["f32 uint8"], i), 1e-3)

    # The kernel tail vs the plain tail on the same raw grids.
    _, boxes, _, args = nms_inputs(torch, nms_cuda, m32,
                                   torch.from_numpy(f32).cuda())
    with torch.inference_mode():
        keep_k = nms_cuda.suppress_rank(*args)
        keep_p = nms_cuda.suppress_rank_reference(*args)
        check(torch.equal(keep_k, keep_p), "kernel tail != plain tail")
        tail_k = nms_cuda.merge(keep_k, args[1], boxes, m32.max_boxes, True)
        tail_p = nms_cuda.merge(keep_p, args[1], boxes, m32.max_boxes, True)
        check(all(torch.equal(a, b) for a, b in zip(tail_k, tail_p)),
              "kernel NMS tail != plain NMS tail")
    worst = max(worst, float((keep_k - keep_p).abs().max()))
    log(f"NMS tail on the main path's grids: kernel == plain, "
        f"valid {tail_k[3].tolist()}")

    # float32 on the card vs the port on the CPU, one image.
    cpu = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES),
                 device="cpu")
    cpu.sync_params(params, cpu.state)
    want = cpu.predict_batch(f32[:1])
    dev = match_detections(numpy_outputs(outs["f32 float"], 0),
                           numpy_outputs(want, 0), 1e-3)
    log(f"card f32 vs CPU f32, image 0: {int(want[3][0])} detections, "
        f"classes and count equal, max deviation {dev:.3g} (limit 1e-3)")

    jpg = SCRATCH / "scene.jpg"
    cv2.imwrite(str(jpg), cv2.resize(u8[0], (640, 480))[:, :, ::-1])
    df = m32.predict(str(jpg), plot_img=False)
    check(len(df) > 0 and list(df.columns)[:5] ==
          ["x1", "y1", "x2", "y2", "class_name"], "predict() DataFrame")
    log(f"predict({jpg.name}): DataFrame of {len(df)} rows")

    # Times: the kernel at the main path's shapes, and throughput.
    k8 = time_stages(torch, nms_cuda, m32, u8, "b8 f32")
    time_stages(torch, nms_cuda, m16, u8, "b8 bf16")
    u64 = scene(2, 64)
    time_stages(torch, nms_cuda, m16, u64, "b64 bf16")
    for bsz, imgs in ((8, u8), (64, u64)):
        rate = predict_rate(torch, m16, imgs)
        log(f"predict_batch bf16 b{bsz} uint8: {rate:.1f} img/s ({card})")

    kernels = [{"name": "suppress_rank", "route": "cuda",
                "source": "yolov4tpu_torch/csrc/suppress_rank.cu",
                "replaces": "yolov4tpu/ops/nms_pallas.py:191",
                "launches": launches, "max_abs_err": worst,
                "ms": k8["ms"], "plain_ms": k8["plain_ms"],
                "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
                "library_ms": None}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
