"""Smoke run of the PyTorch/CUDA port (yolov4tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. the card (name and power limit, as nvidia-smi reports them) and the
     build of every CUDA kernel from the sources in the checkout;
  2. each NMS kernel against its plain PyTorch version at the main path's
     shapes, results exactly equal: the rank kernel (B=8, C=80, K=256, 100,
     33 and 1024) on random and tie-heavy scores, per-class caps of 0, 1,
     3 and one that bites, an all-empty image, per-class valid counts at
     the 32-bit word edges (31, 32, 33, 64); the sorted kernel (B=8, C=80,
     K=256, 252, 1024, 32 and 33) on dense, sparse, non-prefix, late-valid
     (loop bound below the last valid index) and empty masks;
  3. the main path through the user's entry points: ``Yolov4`` at full
     depth, 416x416, COCO-80, random darknet weights from a seed with the
     head biases calibrated to ~120 boxes per image, ``predict_batch`` at
     batch 8 in float32 and bfloat16 on float and uint8 input.  Launch
     counts are zeroed just before and read just after.  Then: the kernel
     NMS tail equals the plain tail on the same raw grids, float32 on the
     card (TF32 off) matches the port on the CPU within 1e-3 per box,
     ``predict()`` on a written JPEG returns a DataFrame, the kernel's
     device time (CUDA-graph replays, and the kernel alone from the
     profiler) beside its eager time, bound and plain version, and the
     bfloat16 throughput at batch 8 and 64;
  3b. the same with ``nms_impl="pallas"`` (per-class top-K + the sorted
     suppression kernel): ``predict_batch`` at b8 float32 and b8/b64
     bfloat16, the kernel launched once a call; its NMS tail equal to the
     exact plain NMS (``nms_impl="xla"``) on the same boxes and scores, the
     card against the CPU within 1e-3 per box, how many images differ from
     the fast path at score 0.05, the stages' times (the kernel's as
     above, also at the evaluation path's score 0.05) and img/s;
  3c. the evaluation path through the user's entry points: ``export_gt`` ->
     ``export_prediction`` (b8) -> ``eval_map`` over the 16 JPEGs of phase
     5, with the uint8 wire and with letterbox, at the mAP convention's
     score threshold 0.05, and a self-consistency run whose ground truth is
     the card's own detections (mAP exactly 1.0);
  4. the weight-gradient kernel against its plain version at the nine
     shapes of the 37 3x3 stride-1 convs of the training path at 416^2, b8,
     in float32 (CUDA cores) and bfloat16 (tensor cores), plus delta inputs
     in both types (exactly equal), ragged and padded-channel shapes, views
     with a storage offset and two launches bit-equal; its bf16 times per
     shape (route and tile) beside its bound, its plain version and cuDNN's
     wgrad (``torch.nn.grad.conv2d_weight``, a yardstick the port never
     calls), and the per-step ratio of kernel to cuDNN;
  5. the training path through the user's entry points: ``Yolov4`` with
     ``pallas_wgrad=True`` in bfloat16 at full depth, 416x416, COCO-80,
     random darknet weights from a seed, ``fit`` for 2 epochs over a
     ``DataGenerator`` of 16 JPEGs the script writes (b8).  The kernel's
     launch counts are zeroed just before and read just after (37 per step,
     every one on the tensor-core route).
     Then: ``predict_batch`` on the trained weights, the loss falling over
     10 steps on one batch, the device label encoder's first loss equal to
     the host encoder's, float32 gradients with the kernel against cuDNN's
     wgrad on the card and against the port on the CPU (b2), and the train
     step's time split and img/s at b8 and b32, with and without the
     kernel, in turns;
  6. persistence through the user's entry points, at the same size with
     ``nms_impl="pallas"``: ``fit`` for 2 epochs with
     ``CosineAnnealingScheduler``, ``CheckpointCallback`` and
     ``EvalMapCallback`` (which runs the sorted kernel) and ``resume_dir``;
     a fresh facade's ``fit(epochs=3)`` resuming at epoch 2 with the step
     count and the LR continued; a fresh trainer restored from the
     checkpoint bit-equal to the one that wrote it, before and after one
     more step (cuDNN deterministic); ``save_model`` as .npz and .weights
     reloaded by ``Yolov4(weight_path=...)`` and ``load_model``, their
     float32 ``"fast"`` detections equal to the trained facade's; the file
     against ``params_to_jax`` and a ``torch.distributed.checkpoint`` round
     trip; the save, restore and load times and sizes, and an epoch's time
     with and without ``resume_dir``.  The three kernels' launches in it
     are counted into the summary;
  7. int8 post-training quantization and AOT serving through the user's
     entry points, at full depth, 416x416, COCO-80, with well-conditioned
     weights whose head biases are calibrated so the model detects: the
     int8 GEMM (im2col + ``torch._int_mm``) equal to a float64 conv of the
     same int8 operands for one conv per kind and input side and for a
     product of 4 rows; ``Yolov4.quantize`` on 16 scene images for both
     dataflows and both calibration methods, the card's float32 scales
     against the CPU's within 1e-4; int8 ``predict_batch`` ("fast") at b8
     f32, b8 bf16 and b64 bf16, one rank-kernel launch a call; the card's
     float32 int8 raw grids against the CPU's (rel-RMS 1e-2) with the share
     of int8 elements that differ; int8 against float detections at bf16
     (the JAX package's detection-level contract); forward and
     ``predict_batch`` times in turns at b8 and b64, peak memory and a
     profiler split of one int8 b64 forward; then ``serving.export_detector``
     -> ``load_detector`` of the float bf16 "fast", int8 "fast" (uint8
     input) and float "pallas" programs at b8, each equal to the live
     ``predict_batch`` and launching its kernel once a call, and a
     package-free ("cuda", "cpu") "xla" artifact run on both devices, with
     the export, save and load times and sizes.  Its launches are counted
     into the summary;
  8. the augmented training ingest and multi-scale training: (a) a fresh
     g++ build of the native ingest library (``yolov4tpu_torch/csrc/
     yolodata.cpp``) in a new process, its variant, seconds, the host's
     cores and the library's OpenMP threads; (b) 38 JPEGs at photo sizes
     (640x480 to 1920x1080) with 1-8 boxes each, one PNG and one JPEG with
     an EXIF orientation tag; (c) at 416^2 b8, the native ingest against
     the Python path with the same seed for plain, mosaic+hflip+jitter,
     letterbox+hflip and jitter batches (boxes and label grids bit-equal,
     images within the JAX tests' bounds), two native runs bit-equal, the
     worker pool equal to the sequential path, and each batch's route from
     the counters; (d) ingest img/s at 416^2 b8 for {plain,
     mosaic+hflip+jitter, letterbox+hflip+jitter, cutmix} x {Python
     sequential, Python pool, native}; (e) the slice's main path:
     ``Yolov4(pallas_wgrad=True)`` in bfloat16 at full depth, COCO-80,
     random darknet weights, ``fit`` 2 epochs at b8 over the native
     augmented generator with ``multi_scale=(320, 608)`` redrawn every
     batch, the wgrad kernel's launch counts zeroed just before and read
     just after (37 a step at every size, all on the tensor cores), each
     step's size, time and loss, peak memory, then ``predict_batch`` at
     416^2 (one ``suppress_rank`` launch); (f) the wgrad kernel against its
     plain version at every shape of 320^2 and 608^2, b8, float32 and
     bfloat16, and its per-step device time beside cuDNN's and the bound;
     (g) at b32, the train step fed by ``prefetch`` over the native
     augmented generator against the same step on a batch already on the
     card, and the share of the epoch the card waits on the host;
  9. data-parallel training (``yolov4tpu_torch.parallel``) at full depth,
     416^2, COCO-80, random darknet weights, bf16, ``pallas_wgrad=True``:
     (a) NCCL at world size 1 in this process: a ``Trainer`` on
     ``make_mesh(1)`` against a plain one over 2 b8 steps of phase 5's
     JPEGs, bit-equal (cuDNN deterministic), one ``all_reduce`` and 37
     tensor-core wgrad launches a step (counts zeroed just before, read
     just after), ``make_train_step_twophase`` bit-equal to the fused step,
     the b32 step's img/s with and without the mesh in turns and the slab's
     MB and pack / all-reduce / unpack ms; (b) two gloo ranks sharing the
     card (NCCL refuses two ranks on one device), each a process of this
     script (``--dp-worker``): ``Yolov4(num_devices=2, batch_size=4).fit``
     for one epoch over 15 JPEGs (b8, then a ragged 7: rank 1 holds 3 valid
     rows and a pad) with a ragged 7-line validation set and
     ``CheckpointCallback``, then ``predict_batch`` (one ``suppress_rank``
     launch); per rank and step 37 tensor-core wgrad launches and one slab,
     rank 0 alone writing, both ranks' params and BN state equal, and rank
     0's checkpoint against the two steps emulated in this process
     (bit-equal, else rel-RMS 1e-6 per leaf).  Then the process group is
     destroyed;
 10. distributed inference (``Yolov4.distribute``) and the video tool at
     full depth, 416^2, COCO-80, bf16, on phase 3's calibrated weights:
     (a) NCCL at world size 1 in this process: ``distribute(1)`` against
     the plain facade at b8 and a ragged b5, "fast" (one ``suppress_rank``
     launch a call) and "pallas" (one ``suppress`` launch a call), within
     1e-3 per box; ``quantize`` then ``distribute`` against the
     single-device int8 facade; ``utils.profiling.time_fn`` img/s of both
     facades in turns; (b) two gloo ranks sharing the card, each a process
     of this script (``--dist-worker``), rank 1's params offset before
     ``distribute(2)``: b8, b5 and b1 on every rank within 1e-3 per box of
     this process's single-device facade (float32, TF32 off; bf16 against
     the single-device facade on the same row blocks, since a bf16 forward
     of 4 rows rounds otherwise than one of 8), one ``suppress_rank``
     launch and one ``all_gather`` a call, the all_gather's ms;
     ``export_prediction`` (float32) of 8 of phase 5's JPEGs written by
     rank 0 alone, on disk for both ranks when it returns, its files within
     1e-3 of the single-device facade's; (c) a 40-frame 640x360 mp4v clip through the video tool's
     command line (b8), its frames read back and counted, one
     ``suppress_rank`` launch a batch, and frames/s.

Each phase prints its seconds.  The line before the last is one JSON object with each kernel's launches,
error against its plain version, times (``device_ms`` from CUDA-graph
replays beside the eager ``ms`` for the NMS kernels) and bound; the last
line is
``{"ok": true, "device": {...}}``.  Needs CUDA: without it the script exits
with status 1 at once.
"""

from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

from yolov4tpu_torch.tools.measure import (cuda_ms, graph_ms, kernel_times,
                                          wgrad_shapes)

ROOT = pathlib.Path(__file__).resolve().parent
SCRATCH = ROOT / "build" / "chip_smoke"
CLASSES = ROOT / "class_names" / "coco_classes.txt"

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12   # dense, tensor cores
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


# Per-class valid counts of kernel_phase's "counts" case, class c taking
# COUNTS[c % 4]: both sides of the 32-bit word edges of the rank kernel's
# mask rows and of its scanning warp's lanes.
COUNTS = (31, 32, 33, 64)


def synthetic_candidates(rng, b, k, c, kind):
    """Candidate boxes (B, K, 4) clustered so many overlap, some with
    swapped corners, and scores (B, K, C) of the given kind ("counts":
    class c has exactly COUNTS[c % 4] scores above 0.3)."""
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
    elif kind == "counts":
        for ci in range(c):
            above = rng.permuted(np.tile(np.arange(k) < COUNTS[ci % 4],
                                         (b, 1)), axis=1)
            scores[:, :, ci] = np.where(above, 0.31 + 0.69 * scores[:, :, ci],
                                        0.29 * scores[:, :, ci])
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
    cases = [("random", 8, 256, 100, 0.3), ("ties", 8, 256, 100, 0.3),
             ("ties", 8, 256, 3, 0.3), ("empty", 8, 256, 100, 0.3),
             ("random", 8, 100, 100, 0.3),
             # every candidate valid: 32 mask words, every lane of the
             # scanning warp, and a cap that does not stop the scan
             ("random", 8, 1024, 1024, 0.0),
             ("random", 8, 33, 100, 0.3),        # one bit in the 2nd word
             ("ties", 8, 256, 0, 0.3), ("random", 8, 256, 1, 0.3),
             ("counts", 8, 256, 100, 0.3), ("counts", 8, 256, 32, 0.3)]
    for kind, b, k, cap, score_t in cases:
        boxes, scores = synthetic_candidates(rng, b, k, 80, kind)
        coords, sc, rank = nms_cuda.rank_inputs(
            torch.from_numpy(boxes).cuda(), torch.from_numpy(scores).cuda())
        got = nms_cuda.suppress_rank(coords, sc, rank, 0.413, score_t, cap)
        torch.cuda.synchronize()
        want = nms_cuda.suppress_rank_reference(coords, sc, rank, 0.413,
                                                score_t, cap)
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"kernel != plain version ({kind}, K={k}, cap={cap}): "
              f"{int((got != want).sum())} entries differ")
        if kind == "empty":
            check(not got[0].any(), "the empty image kept a box")
        if kind == "counts":
            nvalid = (sc > score_t).sum(-1).cpu()
            want_n = torch.tensor(COUNTS).repeat(20).expand(b, -1)
            check(torch.equal(nvalid, want_n), "the counts case's valid "
                  "counts are not 31, 32, 33, 64")
        check(int(got.sum(-1).max()) <= max(cap, 0),
              "the per-class cap was exceeded")
        check(cap == 0 or kind == "empty" or bool(got.any()),
              f"{kind}: nothing was kept")
        worst = max(worst, err)
        log(f"kernel vs plain: {kind} B={b} C=80 K={k} cap={cap} score "
            f"{score_t}: {int((sc > score_t).sum())} valid, {int(got.sum())} "
            f"kept, equal (max abs err {err})")
    # The launch function refuses what the kernel cannot take with an error
    # code (the wrapper raises on any), rather than launching.
    stream = torch.cuda.current_stream().cuda_stream
    code = nms_cuda._library()(None, None, None, None, 1, 1, 1025, 0.4, 0.3,
                               1, stream)
    check(code != 0, "suppress_rank_launch took K=1025")
    log(f"suppress_rank_launch at K=1025 returns CUDA error {code}")
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


def nms_kernel_times(call, floor_call, long_call, kernel_name):
    """A suppression wrapper's device time per call on the main path's
    inputs, and what bounds it, in ms: ``call`` as CUDA-graph replays of
    the whole wrapper (``graph_ms``) and as the profiler's time of the
    kernel alone (without the wrapper's torch ops, if any); then the kernel
    alone on the same shapes with nothing valid (``floor_call``: the
    launch, the loads, the barriers and the store) and at IoU threshold 1.0
    (``long_call``: no suppression, so the same phase 1 and a scan step for
    every valid pivot)."""
    def alone(fn):
        # The profiler now and then reports no event for a short kernel
        # after many sessions in one process: retry, then report the time
        # as not measured (NaN) rather than fail the run over it.
        for _ in range(3):
            ms = sum(v for k, v in kernel_times(fn).items()
                     if kernel_name in k)
            if ms > 0:
                return ms
        log(f"the profiler saw no device time of {kernel_name}: not "
            f"measured")
        return float("nan")
    return graph_ms(call), alone(call), alone(floor_call), alone(long_call)


def scan_steps(keep, bound=None):
    """The most scan steps any (class, image) took: its kept pivots (below
    each image's loop bound, if given)."""
    kept = keep > 0.5
    if bound is not None:
        col = bound.new_tensor(range(keep.shape[-1]))
        kept &= col < bound[:, None, None]
    return int(kept.sum(-1).max())


def time_stages(torch, nms_cuda, model, imgs_u8, label, card):
    """Each stage of predict_batch timed alone on the main path's inputs
    (CUDA events around repeated calls; eager stages include their host
    time), and the kernel's device time against its plain version and its
    bound."""
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
        iou_t, score_t, cap = args[3:]
        device_ms, alone_ms, floor, longest = nms_kernel_times(
            lambda: nms_cuda.suppress_rank(*args),
            lambda: nms_cuda.suppress_rank(coords, sc, rank, iou_t,
                                           float("inf"), cap),
            lambda: nms_cuda.suppress_rank(coords, sc, rank, 1.0, score_t,
                                           cap),
            "suppress_rank_kernel")
        long_steps = scan_steps(nms_cuda.suppress_rank(coords, sc, rank, 1.0,
                                                       score_t, cap))
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
        f"max {int(nvalid.max())} mean {float(nvalid.float().mean()):.2f}, "
        f"{int(nvalid.sum())} valid, {int(keep.sum())} kept: device "
        f"{device_ms:.5f} ms (graph replays; kernel alone {alone_ms:.5f}), "
        f"eager {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound:.6f} ms "
        f"({bound_by}) ({card})")
    log(f"suppress_rank {label} phases, kernel alone: nothing valid "
        f"{floor:.5f} ms; this call {alone_ms:.5f} ms, at most "
        f"{scan_steps(keep)} scan steps in a class; IoU threshold 1.0 "
        f"{longest:.5f} ms, at most {long_steps} steps ({card})")
    log(f"stages {label} (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" ({card})")
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, max_abs_err=err)


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

# ---------------------------------------------------------------------------
# The sorted suppression kernel, nms_impl="pallas" and the evaluation path
# ---------------------------------------------------------------------------

def sorted_candidates(torch, rng, b, c, k, kind):
    """The sorted kernel's inputs on the card: corner planes (B, 4, C, K)
    of overlapping boxes with lo <= hi, and a 0/1 valid mask (B, C, K):
    every candidate ("dense"), a short prefix per class ("sparse", as at a
    high score threshold), a random non-prefix mask, a sparse non-prefix
    mask whose last candidate is valid ("late"), or none ("empty")."""
    xy = rng.uniform(0.2, 0.8, (b, c, k, 2))
    wh = rng.uniform(0.05, 0.25, (b, c, k, 2))
    lo, hi = np.clip(xy - wh / 2, 0, 1), np.clip(xy + wh / 2, 0, 1)
    coords = np.stack([lo[..., 0], lo[..., 1], hi[..., 0], hi[..., 1]], 1)
    if kind == "dense":
        valid = np.ones((b, c, k), bool)
    elif kind == "sparse":
        valid = np.arange(k) < rng.integers(0, 12, (b, c, 1))
    elif kind == "non-prefix":
        valid = rng.uniform(size=(b, c, k)) < 0.5
    elif kind == "late":      # non-prefix, the last candidate always valid
        valid = rng.uniform(size=(b, c, k)) < 0.05
        valid[..., -1] = True
    else:
        valid = np.zeros((b, c, k), bool)
    return (torch.from_numpy(coords.astype(np.float32)).cuda(),
            torch.from_numpy(valid.astype(np.float32)).cuda())


def sorted_kernel_phase(torch, nms_cuda):
    """Phase 2b: the sorted suppression kernel against its plain version."""
    rng = np.random.default_rng(1)
    worst = 0.0
    for kind, k in (("dense", 256), ("sparse", 256), ("non-prefix", 256),
                    ("empty", 256), ("dense", 252), ("non-prefix", 252),
                    ("dense", 1024), ("dense", 32), ("dense", 33),
                    ("late", 256)):
        coords, valid = sorted_candidates(torch, rng, 8, 80, k, kind)
        got = nms_cuda.suppress(coords, valid, 0.413)
        torch.cuda.synchronize()
        want = nms_cuda.suppress_reference(coords, valid, 0.413)
        err = float((got - want).abs().max())
        check(torch.equal(got, want),
              f"suppress kernel != plain version ({kind}, K={k}): "
              f"{int((got != want).sum())} entries differ")
        if kind == "late":
            # Each image's bound sits below its classes' last valid index,
            # so the valid candidates past it are never pivots.
            nmax = nms_cuda._loop_bounds(valid)
            check(bool((nmax < k - 1).all()), f"late: loop bounds "
                  f"{nmax.tolist()} reach the last candidate")
        check(not bool((got > valid).any()), f"{kind}: an invalid candidate "
              "was kept")
        check(kind == "empty" or bool((got < valid).any()),
              f"{kind}: nothing was suppressed")
        worst = max(worst, err)
        log(f"suppress vs plain: {kind} B=8 C=80 K={k}: {int(valid.sum())} "
            f"valid, {int(got.sum())} kept, equal (max abs err {err})")
    try:
        nms_cuda.suppress(torch.zeros(1, 4, 1, 1025, device="cuda"),
                          torch.zeros(1, 1, 1025, device="cuda"), 0.4)
    except ValueError as e:
        log(f"suppress at K=1025 raises: {e}")
    else:
        raise SmokeFailure("suppress took K=1025, past its limit of 1024")
    stream = torch.cuda.current_stream().cuda_stream
    code = nms_cuda._suppress_library()(None, None, None, None, 1, 1, 1025,
                                        0.4, stream)
    check(code != 0, "suppress_launch took K=1025")
    log(f"suppress_launch at K=1025 returns CUDA error {code}")
    return worst


def sorted_path_inputs(torch, nms_cuda, model, images, score_threshold=None):
    """The forward, decode and per-class top-K of the ``"pallas"`` path on
    device ``images`` (at the model's score threshold unless another is
    given): returns (raws, boxes, scores, (top_scores, top_boxes, coords,
    valid))."""
    from yolov4tpu_torch.models import head
    cfg = model.config
    if score_threshold is None:
        score_threshold = cfg.score_threshold
    with torch.inference_mode():
        raws = model._raw(images)
        boxes, scores = head.flatten_boxes_scores(
            head.decode_head(raws, cfg.anchors_grouped, model.num_classes,
                             cfg.strides, cfg.xyscale),
            cfg.img_size[0], model.num_classes)
        staged = nms_cuda.sorted_inputs(boxes, scores, score_threshold,
                                        cfg.nms_pre_top_k)
    return raws, boxes, scores, staged


def sorted_bound_ms(torch, coords, valid, keep, nmax):
    """The least time for one sorted suppression call on these inputs: the
    inputs read once and ``keep`` written once at the HBM rate, or the IoU
    tests these inputs need (each surviving pivot below its image's loop
    bound against every valid candidate after it) at the float32 rate,
    whichever is larger.  Returns (ms, "bytes"|"operations")."""
    nbytes = sum(t.numel() * t.element_size()
                 for t in (coords, valid, keep, nmax))
    v = (valid > 0.5).double()
    later = v.flip(-1).cumsum(-1).flip(-1) - v          # valid after each i
    col = torch.arange(valid.shape[-1], device=valid.device)
    pivots = (keep > 0.5) & (col < nmax[:, None, None])
    tests = float((later * pivots).sum())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = tests * IOU_OPS / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sorted_times(torch, nms_cuda, model, imgs_u8, label, card,
                 score_threshold=None):
    """The ``"pallas"`` path's stages timed alone on the main path's inputs
    (at the model's score threshold unless another is given), and the
    sorted kernel's device time against its plain version and its bound."""
    from yolov4tpu_torch.models import head
    from yolov4tpu_torch.ops.nms import finalize
    cfg = model.config
    images = torch.from_numpy(imgs_u8).cuda().float() / 255.0
    raws, boxes, scores, staged = sorted_path_inputs(
        torch, nms_cuda, model, images, score_threshold)
    top_scores, top_boxes, coords, valid = staged
    iou = cfg.iou_threshold
    with torch.inference_mode():
        keep = nms_cuda.suppress(coords, valid, iou)
        want = nms_cuda.suppress_reference(coords, valid, iou)
        err = float((keep - want).abs().max())
        check(torch.equal(keep, want), f"suppress != plain version ({label})")
        empty = torch.zeros_like(valid)
        device_ms, alone_ms, floor, longest = nms_kernel_times(
            lambda: nms_cuda.suppress(coords, valid, iou),
            lambda: nms_cuda.suppress(coords, empty, iou),
            lambda: nms_cuda.suppress(coords, valid, 1.0),
            "suppress_kernel")
        nmax = nms_cuda._loop_bounds(valid)
        long_steps = scan_steps(nms_cuda.suppress(coords, valid, 1.0), nmax)
        stages = {
            "forward": cuda_ms(lambda: model._raw(images), n=3),
            "decode + flatten": cuda_ms(lambda: head.flatten_boxes_scores(
                head.decode_head(raws, cfg.anchors_grouped, model.num_classes,
                                 cfg.strides, cfg.xyscale),
                cfg.img_size[0], model.num_classes), n=10),
            "per-class top-k": cuda_ms(lambda: nms_cuda.sorted_inputs(
                boxes, scores, cfg.score_threshold, cfg.nms_pre_top_k), n=10),
            "suppress kernel": cuda_ms(
                lambda: nms_cuda.suppress(coords, valid, iou), n=50),
            "finalize": cuda_ms(lambda: finalize(
                top_scores, top_boxes, keep > 0.5, cfg.max_boxes,
                cfg.max_boxes, True), n=10),
        }
        plain_ms = cuda_ms(
            lambda: nms_cuda.suppress_reference(coords, valid, iou),
            n=1, repeats=3, warmup=1)
    bound, bound_by = sorted_bound_ms(torch, coords, valid, keep, nmax)
    ms = stages["suppress kernel"]
    log(f"suppress {label}: shape {tuple(valid.shape)}, loop bounds "
        f"{int(nmax.min())}-{int(nmax.max())}, valid per class mean "
        f"{float(valid.sum(-1).mean()):.2f}, {int(valid.sum())} valid, "
        f"{int(keep.sum())} kept: device {device_ms:.5f} ms (graph replays, "
        f"with the wrapper's loop-bound reduction; kernel alone "
        f"{alone_ms:.5f}), eager {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
        f"{bound:.6f} ms ({bound_by}) ({card})")
    log(f"suppress {label} phases, kernel alone: nothing valid {floor:.5f} "
        f"ms; this call {alone_ms:.5f} ms, at most {scan_steps(keep, nmax)} "
        f"scan steps in a class; IoU threshold 1.0 {longest:.5f} ms, at most "
        f"{long_steps} steps ({card})")
    log(f"stages pallas {label} (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f" ({card})")
    return dict(ms=ms, device_ms=device_ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by=bound_by, max_abs_err=err)


def pallas_phase(torch, nms_cuda, fast32, fast16, m32p, m16p, cpu, f32, u8,
                 u64, card):
    """Phase 3b: ``predict_batch`` with ``nms_impl="pallas"``, its checks,
    times and rates.  Returns (launches, worst error, b8 f32 timings)."""
    from yolov4tpu_torch.ops.nms import combined_nms
    nms_cuda.LAUNCHES = 0
    nms_cuda.SUPPRESS_LAUNCHES = 0
    outs = {"f32 float b8": m32p.predict_batch(f32),
            "f32 uint8 b8": m32p.predict_batch(u8),
            "bf16 uint8 b8": m16p.predict_batch(u8),
            "bf16 uint8 b64": m16p.predict_batch(u64)}
    torch.cuda.synchronize()
    launches = nms_cuda.SUPPRESS_LAUNCHES
    check(launches == len(outs), f"suppress launched {launches} times in "
          f"{len(outs)} predict_batch calls with nms_impl='pallas'")
    check(nms_cuda.LAUNCHES == 0, "nms_impl='pallas' ran the rank kernel")
    log(f"main path (pallas): {len(outs)} predict_batch calls, suppress "
        f"launched {launches} times, suppress_rank 0")
    for name, out in outs.items():
        boxes, scores, classes, valid = out
        check(tuple(boxes.shape) == (len(valid), 100, 4) and boxes.is_cuda,
              f"pallas {name}: boxes {tuple(boxes.shape)} on {boxes.device}")
        check(all(bool(torch.isfinite(o.float()).all()) for o in out),
              f"pallas {name}: non-finite outputs")
        check(float(boxes.min()) >= 0 and float(boxes.max()) <= 1,
              f"pallas {name}: boxes outside [0, 1]")
        check(int(valid.min()) > 0, f"pallas {name}: an image has no "
              f"detections ({valid.tolist()})")
        log(f"pallas {name}: valid detections {valid.tolist()[:8]}")
    for i in range(8):
        match_detections(numpy_outputs(outs["f32 float b8"], i),
                         numpy_outputs(outs["f32 uint8 b8"], i), 1e-3)

    # The kernel and the NMS tail vs the plain versions on the same boxes.
    cfg = m32p.config
    _, boxes, scores, staged = sorted_path_inputs(
        torch, nms_cuda, m32p, torch.from_numpy(f32).cuda())
    coords, valid = staged[2:]
    kw = dict(iou_threshold=cfg.iou_threshold,
              score_threshold=cfg.score_threshold,
              max_per_class=cfg.max_boxes, max_total=cfg.max_boxes,
              pre_top_k=cfg.nms_pre_top_k)
    with torch.inference_mode():
        keep_k = nms_cuda.suppress(coords, valid, cfg.iou_threshold)
        keep_p = nms_cuda.suppress_reference(coords, valid, cfg.iou_threshold)
        check(torch.equal(keep_k, keep_p), "suppress on the main path's "
              "candidates != plain version")
        tail = nms_cuda.combined_nms_sorted(boxes, scores, **kw)
        exact = combined_nms(boxes, scores, **kw)
        check(all(torch.equal(a, b) for a, b in zip(tail, exact)),
              "pallas NMS tail != exact NMS (nms_impl='xla')")
    worst = float((keep_k - keep_p).abs().max())
    log(f"pallas NMS tail on the main path's boxes == exact NMS "
        f"(nms_impl='xla'), valid {tail[3].tolist()}")

    want = cpu.predict_batch(f32[:1])
    dev = match_detections(numpy_outputs(outs["f32 float b8"], 0),
                           numpy_outputs(want, 0), 1e-3)
    log(f"pallas card f32 vs CPU f32, image 0: {int(want[3][0])} "
        f"detections, classes and count equal, max deviation {dev:.3g} "
        f"(limit 1e-3)")

    # Information only: where the fast path's 256 global candidates stop
    # being exact.
    with torch.inference_mode():
        best = scores.max(dim=-1).values
    fast = fast32.predict_batch(f32, score_threshold=0.05)
    slow = m32p.predict_batch(f32, score_threshold=0.05)
    differ = 0
    for i in range(len(f32)):
        try:
            match_detections(numpy_outputs(fast, i), numpy_outputs(slow, i),
                             1e-3)
        except SmokeFailure:
            differ += 1
    log(f"score 0.05, f32 b8: boxes above 0.05 on their best class per "
        f"image {(best > 0.05).sum(-1).tolist()}; 'fast' and 'pallas' "
        f"detections differ (beyond 1e-3, or in count or class) on "
        f"{differ} of {len(f32)} images (valid {fast[3].tolist()} vs "
        f"{slow[3].tolist()})")

    t8 = sorted_times(torch, nms_cuda, m32p, u8, "b8 f32", card)
    sorted_times(torch, nms_cuda, m16p, u8, "b8 bf16", card)
    sorted_times(torch, nms_cuda, m16p, u64, "b64 bf16", card)
    # The evaluation path's dense case: the mAP convention's score 0.05.
    sorted_times(torch, nms_cuda, m32p, u8, "b8 f32 score 0.05", card,
                 score_threshold=0.05)
    for bsz, imgs in ((8, u8), (64, u64)):
        rates = [(name, predict_rate(torch, m, imgs)) for name, m in
                 (("fast", fast16), ("pallas", m16p), ("pallas", m16p),
                  ("fast", fast16))]
        log(f"predict_batch bf16 b{bsz} uint8 img/s: " + ", ".join(
            f"{n} {r:.1f}" for n, r in rates) + f" ({card})")
    return launches, worst, t8


def underscored_classes():
    """COCO's 80 names with spaces as underscores: the evaluation files
    split lines on whitespace (as the reference's do), so a name such as
    "traffic light" would break eval_map."""
    path = SCRATCH / "coco_classes_underscored.txt"
    path.write_text("".join(line.strip().replace(" ", "_") + "\n"
                            for line in CLASSES.read_text().splitlines()))
    return path


def evaluate(torch, nms_cuda, model, anno, folder, out, plot=True):
    """export_gt -> export_prediction (b8) -> eval_map into ``out``; checks
    the launches, the files and the mAP.  Returns (mAP, seconds of the
    export, detections written, the sorted kernel's launches)."""
    import shutil
    shutil.rmtree(out, ignore_errors=True)
    d = {k: str(out / k) for k in ("gt", "pred", "json", "out")}
    n_images = len(anno.read_text().splitlines())
    model.export_gt(str(anno), d["gt"])
    nms_cuda.SUPPRESS_LAUNCHES = 0
    t0 = time.perf_counter()
    model.export_prediction(str(anno), d["pred"], str(folder), bs=8,
                            verbose=False)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    launches = nms_cuda.SUPPRESS_LAUNCHES
    check(launches == -(-n_images // 8), f"export_prediction launched the "
          f"sorted kernel {launches} times for {n_images} images at b8")
    preds = sorted((out / "pred").glob("*.txt"))
    check(len(preds) == n_images, f"{len(preds)} prediction files for "
          f"{n_images} images")
    n_det = sum(len(p.read_text().splitlines()) for p in preds)
    res = model.eval_map(d["gt"], d["pred"], d["json"], d["out"], plot=plot,
                         verbose=False)
    m_ap = res["mAP"]
    check(np.isfinite(m_ap) and 0.0 <= m_ap <= 1.0, f"mAP {m_ap}")
    check((out / "out" / "output.txt").exists(), "no output.txt")
    if plot:
        check((out / "out" / "mAP.png").exists(), "no mAP.png")
    return m_ap, export_s, n_det, launches


def eval_phase(torch, nms_cuda, wpath, params, folder, card):
    """Phase 3c: the evaluation path with nms_impl="pallas" at score 0.05,
    on the uint8 wire and with letterbox, then the self-consistency run.
    Returns the sorted kernel's launches over the path."""
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    import importlib.util
    classes = underscored_classes()
    anno = folder / "annotations.txt"
    n = len(anno.read_text().splitlines())
    # eval_map draws its plots with matplotlib, which a machine may lack.
    plot = importlib.util.find_spec("matplotlib") is not None
    if not plot:
        log("matplotlib is not installed: eval_map runs with plot=False")
    base = dataclasses.replace(DEFAULT_CONFIG, nms_impl="pallas",
                               score_threshold=0.05)
    total = 0
    models = {}
    for name, change in (("uint8", dict(transfer_uint8=True)),
                         ("letterbox", dict(letterbox=True))):
        model = Yolov4(weight_path=str(wpath), class_name_path=str(classes),
                       config=dataclasses.replace(base, **change))
        model.sync_params(params, model.state)
        models[name] = model
        out = SCRATCH / "eval" / name
        m_ap, export_s, n_det, launches = evaluate(torch, nms_cuda, model,
                                                   anno, folder, out, plot)
        total += launches
        rerun = []
        for _ in range(2):
            t0 = time.perf_counter()
            model.export_prediction(str(anno), str(out / "pred"), str(folder),
                                    bs=8, verbose=False)
            torch.cuda.synchronize()
            rerun.append(n / (time.perf_counter() - t0))
        log(f"evaluation path ({name}, pallas, score 0.05, b8): {n_det} "
            f"detections over {n} JPEGs, {launches} launches, mAP {m_ap!r} "
            f"against the random boxes, output.txt written (plots: "
            f"{plot}); "
            f"export_prediction {n / export_s:.1f} img/s first run, then "
            f"{', '.join(f'{r:.1f}' for r in rerun)} img/s ({card})")

    # Self-consistency: ground truth = the card's own detections, verbatim.
    model = models["uint8"]
    lines = []
    for txt in sorted((SCRATCH / "eval" / "uint8" / "pred").glob("*.txt")):
        rows = [r.split() for r in txt.read_text().splitlines()]
        if rows:
            objs = [",".join(r[2:6] + [str(model.class_names.index(r[0]))])
                    for r in rows]
            lines.append(f"{txt.stem}.jpg {' '.join(objs)}\n")
    self_anno = SCRATCH / "eval" / "self_annotations.txt"
    self_anno.write_text("".join(lines))
    m_ap, _, n_det, launches = evaluate(torch, nms_cuda, model, self_anno,
                                        folder, SCRATCH / "eval" / "self",
                                        plot=False)
    total += launches
    check(m_ap == 1.0, f"self-consistency mAP {m_ap!r} != 1.0")
    log(f"evaluation self-consistency: {n_det} detections as ground truth "
        f"over {len(lines)} images, mAP {m_ap!r}")
    return total


# ---------------------------------------------------------------------------
# The weight-gradient kernel and the training path
# ---------------------------------------------------------------------------

# The kernel and its plain version both sum B*H*W float32 products per
# entry, in different orders: the kernel in chains of at most one split's
# pixels (a few thousand), the plain version through a float32 matmul.  The
# rounding of such sums is ~sqrt(chain) * 2^-24 of the magnitudes summed,
# below 1e-5 of the largest |entry| at these shapes; 1e-4 leaves a margin
# of ten and still fails any wrong tap, shift or edge by orders of
# magnitude.  On the tensor-core route the products of bfloat16 operands
# are exact in float32 and the mma accumulates them in float32 (with its
# own rounding inside each 16-deep step), so the same bound holds.
WGRAD_TOL = 1e-4
# Float32 training, card vs the port on the CPU: the training forward's
# one-pass BatchNorm moments (E[y^2] - E[y]^2 in float32, over up to
# 346,112 values a channel at 416^2, b2) make the loss and the gradients
# sensitive to summation order, which differs between the card and the CPU
# at every conv and every moment (the CPU tests measure up to 13% rel-RMS
# at 64 px when the JAX package's own inputs move by one ulp).  Measured
# here on the first runs: loss 9.4e-5 rel, gradients up to 6.9% rel-RMS
# (median 5.2%), while the card's own gradients move by up to 10% (median
# 7.8%) when the images move by a relative 1e-6.  So: the loss within 2e-4;
# the median and the largest gradient leaf error within twice the card's
# own median and largest movement, measured in the same run; and the three
# head convs, which no BatchNorm follows, within 1e-3 rel-RMS.
CPU_LOSS_TOL = 2e-4
HEAD_GRAD_TOL = 1e-3
NOISE_EPS = 1e-6


def wgrad_bound_ms(b, h, w, ci, co, itemsize):
    """The least time for one wgrad: x and dy read once and the float32
    (3,3,Ci,Co) result written once at the HBM rate, or its 2*9*K*Ci*Co
    operations at the peak for the operand type (bf16 tensor cores, or
    float32 outside them), whichever is larger."""
    ops = 2 * 9 * b * h * w * ci * co
    nbytes = b * h * w * (ci + co) * itemsize + 9 * ci * co * 4
    peak = BF16_OPS_PER_S if itemsize == 2 else F32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def wgrad_pair(torch, gen, b, h, w, ci, co, dtype):
    """x (B,H,W,Ci) and dy (B,H,W,Co) normal(0, 1) on the card."""
    x = torch.randn((b, h, w, ci), generator=gen, device="cuda").to(dtype)
    dy = torch.randn((b, h, w, co), generator=gen, device="cuda").to(dtype)
    return x, dy


def wgrad_check(torch, wgrad_cuda, x, dy, label, exact=False):
    """The kernel against its plain version on the same tensors: returns
    (max abs error, that error over the largest |entry|)."""
    got = wgrad_cuda.wgrad_3x3_s1(x, dy)
    torch.cuda.synchronize()
    want = wgrad_cuda.wgrad_3x3_s1_reference(x, dy)
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if exact:
        check(torch.equal(got, want), f"wgrad {label}: kernel != plain "
              f"(max abs err {err})")
    else:
        check(err <= WGRAD_TOL * scale, f"wgrad {label}: max abs err {err} "
              f"> {WGRAD_TOL} x {scale}")
    return err, err / max(scale, 1e-30)


def wgrad_shape_checks(torch, wgrad_cuda, shapes, gen):
    """The kernel against its plain version at each (H, Ci, Co) of
    ``shapes``, b8, float32 and bfloat16.  Returns the largest bf16 abs
    error."""
    worst_bf16 = 0.0
    for (h, ci, co), n in sorted(shapes.items(), key=lambda kv: -kv[0][0]):
        for dtype in (torch.float32, torch.bfloat16):
            x, dy = wgrad_pair(torch, gen, 8, h, h, ci, co, dtype)
            err, rel = wgrad_check(torch, wgrad_cuda, x, dy,
                                   f"{h}^2 {ci}->{co} {dtype}")
            if dtype == torch.bfloat16:
                worst_bf16 = max(worst_bf16, err)
            log(f"wgrad kernel vs plain: b8 {h}x{h} {ci}->{co} "
                f"({n} convs) {str(dtype)[6:]}: max abs err {err:.3g} "
                f"({rel:.2g} of the largest entry, limit {WGRAD_TOL})")
    return worst_bf16


def wgrad_phase(torch, wgrad_cuda, shapes):
    """Phase 4a: the kernel against its plain version at the training
    path's shapes (b8, float32 and bfloat16), delta inputs (exactly equal),
    ragged and padded-channel shapes, views with a storage offset, and two
    launches bit-equal.  Returns the largest abs error at the main path's
    b8 bf16."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst_bf16 = wgrad_shape_checks(torch, wgrad_cuda, shapes, gen)
    for dtype in (torch.float32, torch.bfloat16):
        for corner in ((0, 0), (12, 12), (0, 12)):
            x = torch.zeros((1, 13, 13, 8), device="cuda", dtype=dtype)
            dy = torch.zeros((1, 13, 13, 8), device="cuda", dtype=dtype)
            x[0, corner[0], corner[1], 0] = 1.0
            dy[0, corner[0], corner[1], 0] = 1.0
            wgrad_check(torch, wgrad_cuda, x, dy, f"delta {corner} {dtype}",
                        exact=True)
            got = wgrad_cuda.wgrad_3x3_s1(x, dy)
            check(float(got[1, 1, 0, 0]) == 1.0
                  and float(got.abs().sum()) == 1.0,
                  f"delta {corner} {dtype}: an edge tap did not see zero "
                  f"padding")
        log(f"wgrad kernel vs plain: delta inputs at three corners of 13x13 "
            f"{str(dtype)[6:]}: exactly equal, only the centre tap set")
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, ci, co in ((3, 13, 17, 96, 80), (2, 13, 17, 3, 20),
                                (3, 13, 17, 5, 7)):
            x, dy = wgrad_pair(torch, gen, b, h, w, ci, co, dtype)
            err, rel = wgrad_check(torch, wgrad_cuda, x, dy,
                                   f"B={b} {h}x{w} {ci}->{co} {dtype}")
            log(f"wgrad kernel vs plain: ragged B={b} {h}x{w} {ci}->{co} "
                f"{str(dtype)[6:]}: max abs err {err:.3g} ({rel:.2g})")
        # Views with a storage offset: one batch further into a larger
        # tensor (16-byte aligned), and one element in (not aligned).
        x, dy = wgrad_pair(torch, gen, 3, 26, 26, 64, 64, dtype)
        flat_x = torch.randn(x.numel() + 1, generator=gen,
                             device="cuda").to(dtype)
        flat_dy = torch.randn(dy.numel() + 1, generator=gen,
                              device="cuda").to(dtype)
        views = {"batch offset": (x[1:], dy[1:]),
                 "one element in": (flat_x[1:].view(x.shape),
                                    flat_dy[1:].view(dy.shape))}
        for name, (xv, dyv) in views.items():
            err, rel = wgrad_check(torch, wgrad_cuda, xv, dyv,
                                   f"view {name} {dtype}")
            log(f"wgrad kernel vs plain: view with storage offset "
                f"{xv.storage_offset()} ({name}), {tuple(xv.shape)} "
                f"{str(dtype)[6:]}: max abs err {err:.3g} ({rel:.2g})")
    for dtype in (torch.float32, torch.bfloat16):
        x, dy = wgrad_pair(torch, gen, 8, 52, 52, 128, 128, dtype)
        first = wgrad_cuda.wgrad_3x3_s1(x, dy)
        second = wgrad_cuda.wgrad_3x3_s1(x, dy)
        check(torch.equal(first, second), f"wgrad {dtype}: two launches on "
              f"the same inputs differ")
        log(f"wgrad kernel: two launches on b8 52x52 128->128 "
            f"{str(dtype)[6:]} are bit-equal")
    return worst_bf16


def wgrad_times(torch, wgrad_cuda, shapes, card):
    """Phase 4b: per shape at b8 bf16, the kernel, its plain version and
    cuDNN's wgrad (library yardstick) against the bound; and the sums over
    one training step's launches.  Kernel and cuDNN times are device times
    (``graph_ms``); their eager times, host launch cost included, are
    printed beside them."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    step = collections.Counter()
    bound_by = {"operations": 0.0, "bytes": 0.0}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (h, ci, co), n in sorted(shapes.items(), key=lambda kv: -kv[0][0]):
        x, dy = wgrad_pair(torch, gen, 8, h, h, ci, co, torch.bfloat16)
        xn, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
        kernel = lambda: wgrad_cuda.wgrad_3x3_s1(x, dy)
        cudnn = lambda: torch.nn.grad.conv2d_weight(
            xn, (co, ci, 3, 3), dyn, padding=1)
        ms, lib = graph_ms(kernel), graph_ms(cudnn)
        eager, lib_eager = cuda_ms(kernel, n=20), cuda_ms(cudnn, n=20)
        plain = cuda_ms(lambda: wgrad_cuda.wgrad_3x3_s1_reference(x, dy),
                        n=1, repeats=3, warmup=1)
        bound, by = wgrad_bound_ms(8, h, h, ci, co, 2)
        tile, splits, chunk = wgrad_cuda.plan(8, h, h, ci, co, sms,
                                              torch.bfloat16)
        log(f"wgrad b8 bf16 {h}x{h} {ci}->{co} x{n}: kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, cuDNN {lib:.4f} ms, bound {bound:.5f} ms "
            f"({by}); eager launches: kernel {eager:.4f} ms, cuDNN "
            f"{lib_eager:.4f} ms; kernel at {bound / ms:.2%} of bound, "
            f"{2 * 9 * 8 * h * h * ci * co / ms / 1e9:.1f} TFLOP/s; route "
            f"tensor cores (mma.sync), tile {tile}x{tile}, {splits} splits "
            f"of {chunk} px ({card})")
        for key, v in (("ms", ms), ("plain_ms", plain), ("library_ms", lib),
                       ("bound_ms", bound), ("eager_ms", eager),
                       ("library_eager_ms", lib_eager)):
            step[key] += n * v
        bound_by[by] += n * bound
    step["launches"] = sum(shapes.values())
    by = max(bound_by, key=bound_by.get)
    log(f"wgrad per b8 bf16 step ({step['launches']} launches): kernel "
        f"{step['ms']:.3f} ms, plain {step['plain_ms']:.3f} ms, cuDNN "
        f"{step['library_ms']:.3f} ms, bound {step['bound_ms']:.4f} ms "
        f"({by}); kernel / cuDNN {step['ms'] / step['library_ms']:.3f}; "
        f"eager launches: kernel {step['eager_ms']:.3f} ms, cuDNN "
        f"{step['library_eager_ms']:.3f} ms ({card})")
    return dict(step, bound_by=by)


def write_train_set(folder: pathlib.Path, n: int = 16, seed: int = 0):
    """n JPEGs (scene rasters at a few sizes) with 2-8 boxes each and their
    annotation file, lines "name x1,y1,x2,y2,class ..." -> its lines."""
    import cv2
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    lines = []
    for i in range(n):
        h, w = (480, 640) if i % 2 else (416, 500)
        img = cv2.resize(scene(seed * 100 + i, 1)[0], (w, h))
        cv2.imwrite(str(folder / f"train{i}.jpg"), img)
        boxes = []
        for _ in range(int(rng.integers(2, 9))):
            x1, y1 = int(rng.integers(0, w - 40)), int(rng.integers(0, h - 40))
            x2 = int(rng.integers(x1 + 16, min(x1 + 300, w)))
            y2 = int(rng.integers(y1 + 16, min(y1 + 300, h)))
            boxes.append(f"{x1},{y1},{x2},{y2},{int(rng.integers(0, 80))}")
        lines.append(f"train{i}.jpg " + " ".join(boxes))
    anno = folder / "annotations.txt"
    anno.write_text("\n".join(lines) + "\n")
    return anno.read_text().splitlines()


def grad_rel_rms(got, want):
    """Per conv leaf (in order) the rel-RMS of got against want."""
    out = []
    for p, q in zip(got["convs"], want["convs"]):
        for k in p:
            a, b = p[k].double().cpu(), q[k].double().cpu()
            out.append(float((a - b).pow(2).mean().sqrt()
                             / b.pow(2).mean().sqrt().clamp_min(1e-30)))
    return out


def train_phase(torch, wgrad_cuda, wpath, folder, lines, card, shapes):
    """Phase 5: the training path through the entry points, then its
    checks.  Returns the kernel's launches in the main-path fit."""
    from yolov4tpu_torch import train
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator

    cfg = dataclasses.replace(DEFAULT_CONFIG, pallas_wgrad=True,
                              compute_dtype="bfloat16")
    gen = DataGenerator(lines, str(CLASSES), str(folder), config=cfg, seed=0)
    model = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES),
                   config=cfg)
    params0, state0 = model.params, model.state   # fit swaps in new dicts
    per_step = sum(shapes.values())

    wgrad_cuda.LAUNCHES = 0
    wgrad_cuda.TC_LAUNCHES = 0
    t0 = time.perf_counter()
    history = model.fit(gen, epochs=2, verbose=False)
    torch.cuda.synchronize()
    launches = wgrad_cuda.LAUNCHES
    tc_launches = wgrad_cuda.TC_LAUNCHES
    fit_s = time.perf_counter() - t0
    trainer = model.trainer()
    steps = trainer.global_step
    check(steps == 2 * len(gen), f"fit ran {steps} steps, not {2 * len(gen)}")
    check(launches == per_step * steps, f"wgrad launched {launches} times in "
          f"{steps} steps, not {per_step} per step")
    check(tc_launches == launches, f"only {tc_launches} of the bf16 fit's "
          f"{launches} wgrad launches took the tensor-core route")
    check(all(np.isfinite(h["loss"]) for h in history),
          f"non-finite loss in {history}")
    check(trainer.params["convs"][0]["w"].is_cuda, "params are not on the card")
    log(f"main path (training): fit 2 epochs x {len(gen)} steps at b8 bf16, "
        f"pallas_wgrad: wgrad launched {launches} times ({per_step} per "
        f"step), {tc_launches} on the tensor-core route, epoch losses {[round(h['loss'], 3) for h in history]}, "
        f"{fit_s:.1f} s with JPEG decode and the first steps' set-up "
        f"({card})")

    u8 = scene(3, 8)
    boxes, scores, classes, valid = model.predict_batch(u8)
    check(boxes.is_cuda and tuple(boxes.shape) == (8, 100, 4),
          "predict_batch after fit")
    check(all(bool(torch.isfinite(o.float()).all())
              for o in (boxes, scores, classes, valid)),
          "non-finite detections after fit")
    log(f"predict_batch on the trained weights: finite, valid detections "
        f"{valid.tolist()}")

    batch = gen.get_batch(0)
    losses = [float(trainer.train_step(batch)["loss"]) for _ in range(10)]
    check(all(np.isfinite(losses)), f"non-finite loss in {losses}")
    check(losses[-1] < losses[0], f"loss did not fall over 10 steps on one "
          f"batch: {losses}")
    log(f"10 steps on one batch: loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    del trainer, model
    torch.cuda.empty_cache()

    dev_cfg = dataclasses.replace(cfg, encode_on_device=True)
    firsts = []
    for c in (cfg, dev_cfg):
        g = DataGenerator(lines, str(CLASSES), str(folder), config=c, seed=5)
        t = train.Trainer(c, 80, params0, state0)
        firsts.append(float(t.train_step(g.get_batch(0))["loss"]))
        del t
    check(abs(firsts[1] - firsts[0]) <= 1e-6 * abs(firsts[0]),
          f"device-encoded first loss {firsts[1]} != host-encoded "
          f"{firsts[0]}")
    log(f"encode_on_device: first-step loss {firsts[1]!r} == host-encoded "
        f"{firsts[0]!r}")
    torch.cuda.empty_cache()
    return launches, params0, state0


def fidelity_phase(torch, params0, state0, folder, lines, card):
    """Phase 5b: float32 (TF32 off) gradients at full depth, b2: the kernel
    against cuDNN's wgrad on the card, and the card against the CPU."""
    from yolov4tpu_torch import train
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator

    cfg = dataclasses.replace(DEFAULT_CONFIG, pallas_wgrad=True, batch_size=2)
    batch = train.tree_map(torch.as_tensor, DataGenerator(
        lines, str(CLASSES), str(folder), config=cfg, seed=7).get_batch(0))

    def run(c, device, b=batch):
        on = train.tree_map(lambda t: t.to(device), (params0, state0, b))
        out = train._make_grad_and_metrics(80, c)(*on)
        return train.tree_map(lambda t: t.detach().cpu(), out)

    g_k, st_k, m_k = run(cfg, "cuda")
    g_c, st_c, m_c = run(dataclasses.replace(cfg, pallas_wgrad=False), "cuda")
    loss_k, loss_c = float(m_k["loss"]), float(m_c["loss"])
    check(abs(loss_k - loss_c) <= 1e-6 * abs(loss_c),
          f"f32 loss with the kernel {loss_k} != with cuDNN wgrad {loss_c}")
    for a, b in zip(st_k["bn"], st_c["bn"]):
        if a is not None:
            for k in ("mean", "var"):
                check(torch.allclose(a[k], b[k], rtol=1e-6, atol=0),
                      "BN state differs between the kernel and cuDNN wgrad")
    rel = grad_rel_rms(g_k, g_c)
    check(max(rel) < 1e-4, f"f32 gradient leaf off by rel-RMS {max(rel)} "
          "(limit 1e-4), kernel vs cuDNN wgrad")
    log(f"fidelity f32 b2 416^2: kernel vs cuDNN wgrad on the card: loss "
        f"{loss_k!r} vs {loss_c!r}, BN state equal, gradient rel-RMS max "
        f"{max(rel):.3g} median {statistics.median(rel):.3g} (limit 1e-4)")

    t0 = time.perf_counter()
    g_cpu, _, m_cpu = run(cfg, "cpu")
    cpu_s = time.perf_counter() - t0
    noise = torch.Generator().manual_seed(11)
    image = batch["image"]
    moved = dict(batch, image=image * (1 + NOISE_EPS * torch.randn(
        image.shape, generator=noise)))
    g_p, _, m_p = run(cfg, "cuda", moved)
    loss_cpu, loss_p = float(m_cpu["loss"]), float(m_p["loss"])
    rel, own = grad_rel_rms(g_k, g_cpu), grad_rel_rms(g_p, g_k)
    loss_rel = abs(loss_k - loss_cpu) / abs(loss_cpu)
    heads = [r for r, p in zip(rel, (p for p in params0["convs"] for _ in p))
             if "b" in p]
    med, med_own = statistics.median(rel), statistics.median(own)
    log(f"fidelity f32 b2 416^2: card vs the port on the CPU: loss "
        f"{loss_k!r} vs {loss_cpu!r} (rel {loss_rel:.3g}, limit "
        f"{CPU_LOSS_TOL}; the card's own loss moves by rel "
        f"{abs(loss_p - loss_k) / abs(loss_k):.3g}); gradient rel-RMS max "
        f"{max(rel):.3g} median {med:.3g}, the card's own movement under a "
        f"{NOISE_EPS} relative image perturbation max {max(own):.3g} median "
        f"{med_own:.3g}; head convs max {max(heads):.3g} (limit "
        f"{HEAD_GRAD_TOL}); the CPU's step took {cpu_s:.1f} s on the host")
    check(loss_rel <= CPU_LOSS_TOL, f"f32 loss on the card {loss_k} vs the "
          f"CPU {loss_cpu}: rel {loss_rel} > {CPU_LOSS_TOL}")
    check(med <= 2 * med_own and max(rel) <= 2 * max(own),
          f"f32 gradients card vs CPU (median {med}, max {max(rel)}) beyond "
          f"twice the card's own movement ({med_own}, {max(own)})")
    check(len(heads) == 6 and max(heads) <= HEAD_GRAD_TOL,
          f"head conv gradients card vs CPU off by {max(heads)}")


def step_split(torch, trainer, batch):
    """One train step at the trainer's config split by CUDA events into
    forward+loss, backward and optimizer (ms)."""
    from yolov4tpu_torch import losses, train
    from yolov4tpu_torch.models import network
    cfg = trainer.config
    batch = trainer._place(train.tree_map(torch.as_tensor, batch))
    images = batch["image"]
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    live = [t.detach().requires_grad_(True)
            for t in train.leaves(trainer.params)]
    ev[0].record()
    outs, _ = network.apply(
        train.unflatten(trainer.params, live), trainer.state, images, 80,
        train=True, compute_dtype=train._compute_dtype(cfg),
        pallas_wgrad=cfg.pallas_wgrad)
    total = losses.yolo_loss(outs, batch["labels"], batch["boxes"],
                             cfg.anchors_grouped, cfg.strides, 80,
                             cfg.iou_loss_thresh)
    ev[1].record()
    grads = torch.autograd.grad(total, live)
    ev[2].record()
    trainer.optimizer.step(grads)
    ev[3].record()
    torch.cuda.synchronize()
    return [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def rate_phase(torch, params0, state0, folder, lines, card):
    """Phase 5c: train-step img/s at bf16 b8 and b32 with and without the
    kernel, in turns (kernel, cuDNN, cuDNN, kernel; host clock around steps
    that end in a synchronize, batches already on the card), and the time
    split of one step."""
    from yolov4tpu_torch import train
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator

    base = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="bfloat16")
    b8 = DataGenerator(lines, str(CLASSES), str(folder), config=base,
                       seed=9).get_batch(0)
    rates = {}
    for bsz in (8, 32):
        batch = train.tree_map(
            lambda x: np.concatenate([x] * (bsz // 8)), b8)
        for flag in (True, False, False, True):
            cfg = dataclasses.replace(base, pallas_wgrad=flag,
                                      batch_size=bsz)
            trainer = train.Trainer(cfg, 80, params0, state0)
            dev = trainer._place(train.tree_map(torch.as_tensor, batch))
            for _ in range(2):
                trainer.train_step(dev)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            iters = 5
            t0 = time.perf_counter()
            for _ in range(iters):
                trainer.train_step(dev)
            torch.cuda.synchronize()
            rate = iters * bsz / (time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            split = step_split(torch, trainer, batch)
            rates.setdefault((bsz, flag), []).append(rate)
            log(f"train step bf16 b{bsz} pallas_wgrad={flag}: {rate:.1f} "
                f"img/s ({1e3 * bsz / rate:.1f} ms a step); split "
                f"forward+loss {split[0]:.1f} ms, backward {split[1]:.1f} ms,"
                f" optimizer {split[2]:.1f} ms; peak memory {peak:.1f} GiB "
                f"({card})")
            del trainer, dev
            torch.cuda.empty_cache()
    return rates



# ---------------------------------------------------------------------------
# Persistence: checkpoints, resume, callbacks, save and reload
# ---------------------------------------------------------------------------

def trainer_state(trainer):
    """Everything a train step reads, in order: params, BN state, Adam
    moments and step counts; and (count, LR, global_step)."""
    from yolov4tpu_torch import train
    opt = trainer.optimizer
    moments = [opt.opt.state[t][k] for t in opt.tensors
               for k in ("exp_avg", "exp_avg_sq", "step")]
    return (train.leaves(trainer.params) + train.leaves(trainer.state)
            + moments), (opt.count, trainer.learning_rate,
                         trainer.global_step)


def first_difference(torch, a, b):
    """(index, max abs difference, largest |entry|) of the first pair of
    tensors that differ, or None when all are equal."""
    for i, (x, y) in enumerate(zip(a, b)):
        if not torch.equal(x, y):
            return (i, float((x.double() - y.double()).abs().max()),
                    float(y.double().abs().max()))
    return None


def file_mb(path: pathlib.Path) -> float:
    """Size of a file, or of every file under a directory, in MB."""
    if path.is_dir():
        return sum(p.stat().st_size for p in path.rglob("*")
                   if p.is_file()) / 1e6
    return path.stat().st_size / 1e6


def timed(torch, fn):
    """(seconds, result) of ``fn()`` on the host clock, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def persistence_phase(torch, nms_cuda, wgrad_cuda, wpath, folder, lines,
                      card, per_step):
    """Phase 6: the persistence path through the user's entry points, at
    full depth, 416^2, COCO-80, b8 bf16 with ``pallas_wgrad=True`` and
    ``nms_impl="pallas"``: (a) ``fit`` with the three callbacks and
    ``resume_dir``; (b) a "crashed" run's fresh facade resuming; (c) a
    fresh trainer restored from the checkpoint against the trainer that
    wrote it, bit for bit, before and after one step; (d) ``save_model``
    as .npz and .weights, reloaded, serving equal detections through
    ``nms_impl="fast"``; (e) the file against ``params_to_jax`` and a DCP
    round trip; (f) the times and sizes users feel at every epoch end.
    Returns the launches of the three kernels in (a)-(d)."""
    import shutil

    from yolov4tpu_torch import checkpoint as ckpt
    from yolov4tpu_torch import train, weights
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.callbacks import (CheckpointCallback,
                                           CosineAnnealingScheduler,
                                           EvalMapCallback)
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator
    from yolov4tpu_torch.models.network import params_to_jax

    root = SCRATCH / "persist"
    resume = SCRATCH / "resume"
    for d in (root, resume):          # a rerun must not resume an old run
        shutil.rmtree(d, ignore_errors=True)
    root.mkdir(parents=True)
    classes = str(underscored_classes())
    anno = folder / "annotations.txt"
    cfg = dataclasses.replace(DEFAULT_CONFIG, pallas_wgrad=True,
                              compute_dtype="bfloat16", nms_impl="pallas")
    gen = DataGenerator(lines, classes, str(folder), config=cfg, seed=0)
    n_images = len(lines)
    launches = {"wgrad": 0, "suppress": 0, "suppress_rank": 0}

    def wgrad_counts():
        return wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES

    # --- a. fit with the callbacks and resume_dir ------------------------
    t_phase = time.perf_counter()
    model = Yolov4(weight_path=str(wpath), class_name_path=classes,
                   config=cfg)
    cosine = CosineAnnealingScheduler(1e-3, 1e-5, 4)
    ck = CheckpointCallback(str(root / "ck_{epoch}.npz"), every=1)
    evalmap = EvalMapCallback(model, str(anno), str(folder),
                              str(root / "evalmap"), every=2, verbose=0)
    wgrad_cuda.LAUNCHES = wgrad_cuda.TC_LAUNCHES = 0
    nms_cuda.SUPPRESS_LAUNCHES = 0
    history = model.fit(gen, epochs=2, callbacks=[cosine, ck, evalmap],
                        verbose=False, resume_dir=str(resume))
    torch.cuda.synchronize()
    trainer = model.trainer()
    steps = trainer.global_step
    wl, tc = wgrad_counts()
    sl = nms_cuda.SUPPRESS_LAUNCHES
    calls = -(-n_images // 2)      # export_prediction's batches of 2
    check(steps == 2 * len(gen), f"fit ran {steps} steps")
    check(wl == per_step * steps and tc == wl, f"wgrad launched {wl} times "
          f"({tc} on the tensor cores) in {steps} steps")
    check(sl == calls, f"EvalMapCallback's evaluation launched the sorted "
          f"kernel {sl} times in {calls} predict_batch calls")
    check(cosine.history == [cosine.lr(0), cosine.lr(1)],
          f"LR history {cosine.history}")
    check(all(np.isfinite(h["loss"]) for h in history), f"loss {history}")
    check(len(evalmap.history) == 1 and evalmap.history[0]["epoch"] == 1,
          f"EvalMapCallback history {evalmap.history}")
    for f in (root / "ck_0.npz", root / "ck_1.npz", resume / "latest.npz"):
        check(f.exists(), f"{f} was not written")
    launches["wgrad"] += wl
    launches["suppress"] += sl
    # Phase b overwrites latest.npz; c and e read the file phase a left.
    after_a = root / "after_a.npz"
    shutil.copyfile(resume / "latest.npz", after_a)
    log(f"persistence a: fit 2 epochs x {len(gen)} steps with "
        f"CosineAnnealingScheduler, CheckpointCallback and EvalMapCallback "
        f"(mAP {evalmap.history[0]['mAP']!r}): wgrad launched {wl} times "
        f"({per_step} a step, {tc} on the tensor cores), suppress {sl} "
        f"times in the evaluation's {calls} predict_batch calls, LR "
        f"history {cosine.history}, ck_0.npz, ck_1.npz and latest.npz "
        f"written; {time.perf_counter() - t_phase:.1f} s ({card})")

    # --- b. crash and resume ------------------------------------------------
    t_phase = time.perf_counter()
    crashed = Yolov4(weight_path=str(wpath), class_name_path=classes,
                     config=cfg)
    wgrad_cuda.LAUNCHES = wgrad_cuda.TC_LAUNCHES = 0
    resumed = crashed.fit(gen, epochs=3, verbose=False,
                          resume_dir=str(resume))
    torch.cuda.synchronize()
    t_b = crashed.trainer()
    wl, tc = wgrad_counts()
    lr2 = float(np.float32(cosine.lr(2)))
    check([h["epoch"] for h in resumed] == [2],
          f"the resumed fit ran epochs {[h['epoch'] for h in resumed]}")
    check(t_b.global_step == steps + len(gen),
          f"global_step {t_b.global_step} after resuming at {steps}")
    check(t_b.learning_rate == lr2, f"resumed LR {t_b.learning_rate!r} != "
          f"lr(2) {lr2!r}")
    check(np.isfinite(resumed[0]["loss"]), f"loss {resumed}")
    check(wl == per_step * len(gen) and tc == wl, f"wgrad launched {wl} "
          f"times ({tc} on the tensor cores) in the resumed epoch")
    launches["wgrad"] += wl
    log(f"persistence b: a fresh facade's fit(epochs=3, resume_dir) resumed "
        f"at epoch 2, trained {len(gen)} steps (global_step {steps} -> "
        f"{t_b.global_step}), LR {t_b.learning_rate!r} == lr(2), loss "
        f"{resumed[0]['loss']:.3f}, wgrad {wl} launches; "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")
    del crashed, t_b
    torch.cuda.empty_cache()

    # --- c. exact restore on the card (and e's file check) -------------
    t_phase = time.perf_counter()
    p0, s0 = weights.load_darknet_weights(str(wpath), 80)
    fresh = train.Trainer(cfg, 80, p0, s0)
    check(fresh.restore_checkpoint(str(after_a)) == 2, "restore did not "
          "return epoch 2")
    (ta, sa), (tb, sb) = trainer_state(trainer), trainer_state(fresh)
    check(sa == sb, f"count, LR, global_step {sb} after restore != {sa}")
    diff = first_difference(torch, tb, ta)
    check(len(ta) == len(tb) and diff is None,
          f"restored state differs from the writer's: {diff}")
    check(all(x is y for x, y in zip(fresh.optimizer.tensors,
                                     train.leaves(fresh.params))),
          "the optimizer lost its parameters")
    # e: the file holds params_to_jax of the trainer that wrote it.
    want, _ = params_to_jax(trainer.params, trainer.state)
    with np.load(after_a) as data:
        for i, conv in enumerate(want["convs"]):
            for k, v in conv.items():
                check(np.array_equal(data[f"params/convs/{i}/{k}"], v),
                      f"latest.npz params/convs/{i}/{k} != params_to_jax")
    loaded, _, step, extra = ckpt.load_npz(str(after_a))
    check(step == steps and extra == {"epoch": 1}, f"meta {step} {extra}")
    check(all(train.leaves(train.tree_map(
        lambda a, b: torch.equal(a.cpu(), b), trainer.params, loaded))),
        "load_npz(latest.npz) != the trainer's params")
    log(f"persistence c: a fresh trainer restored from latest.npz holds the "
        f"writer's {len(ta)} tensors bit for bit (params, BN state, Adam "
        f"moments and steps), count, LR and global_step {sa}; e: the file's "
        f"arrays == params_to_jax(trainer.params), load_npz == the params")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    batch = gen.get_batch(0)
    wgrad_cuda.LAUNCHES = wgrad_cuda.TC_LAUNCHES = 0
    loss_a = float(trainer.train_step(batch)["loss"])
    loss_b = float(fresh.train_step(batch)["loss"])
    wl, tc = wgrad_counts()
    check(wl == 2 * per_step and tc == wl, f"wgrad launched {wl} times in "
          f"two steps")
    launches["wgrad"] += wl
    (ta, sa), (tb, sb) = trainer_state(trainer), trainer_state(fresh)
    diff = first_difference(torch, tb, ta)
    if diff is None and loss_a == loss_b:
        log(f"persistence c: one more train_step each (cudnn deterministic): "
            f"bit-equal, loss {loss_a!r}")
    else:
        # Which op is not deterministic: the gradient core twice on the
        # same inputs, and its first differing gradient.
        core = train._make_grad_and_metrics(80, cfg)
        placed = trainer._place(train.tree_map(torch.as_tensor, batch))
        g1 = train.leaves(core(trainer.params, trainer.state, placed)[0])
        g2 = train.leaves(core(trainer.params, trainer.state, placed)[0])
        log(f"persistence c: after one step each the states differ: "
            f"losses {loss_a!r} / {loss_b!r}, first tensor {diff}; the "
            f"gradient core twice on one input: first differing leaf "
            f"{first_difference(torch, g1, g2)}")
        worst = max((float((x.double() - y.double()).abs().max())
                     / max(float(y.double().abs().max()), 1e-30))
                    for x, y in zip(tb, ta))
        check(worst <= 1e-6, f"restored trainer's step off by {worst} of "
              f"the largest entry (limit 1e-6)")
        log(f"persistence c: largest deviation {worst:.3g} of the largest "
            f"entry (limit 1e-6)")
    torch.backends.cudnn.deterministic = False
    log(f"persistence c: {time.perf_counter() - t_phase:.1f} s ({card})")

    # --- d. save, reload, serve ---------------------------------------------
    t_phase = time.perf_counter()
    serve = dataclasses.replace(DEFAULT_CONFIG, nms_impl="fast")
    model.config = serve
    model.sync_params(model.params, model.state)
    f32 = scene(6, 8).astype(np.float32) / 255.0
    with torch.inference_mode():
        raws = model._raw(torch.from_numpy(f32).cuda())
    # Head biases calibrated as in phase 3, so the trained model detects.
    params, _ = weights.calibrate_detection_density(model.params, raws, 80,
                                                    spread=1.0)
    model.sync_params(params, model.state)
    npz, dark = root / "trained.npz", root / "trained.weights"
    save_s = {}
    for path in (npz, dark):
        save_s[path.suffix], _ = timed(torch,
                                       lambda: model.save_model(str(path)))
    load_s, from_npz = timed(torch, lambda: Yolov4(
        weight_path=str(npz), class_name_path=classes, config=serve,
        device="cuda"))
    from_weights = Yolov4(class_name_path=classes, config=serve)
    from_weights.load_model(str(dark))
    nms_cuda.LAUNCHES = 0
    outs = [m.predict_batch(f32) for m in (model, from_npz, from_weights)]
    torch.cuda.synchronize()
    rl = nms_cuda.LAUNCHES
    check(rl == len(outs), f"suppress_rank launched {rl} times in "
          f"{len(outs)} predict_batch calls")
    launches["suppress_rank"] += rl
    check(int(outs[0][3].min()) > 0, f"the trained model detects nothing: "
          f"{outs[0][3].tolist()}")
    for name, out in (("Yolov4(weight_path=.npz)", outs[1]),
                      ("load_model(.weights)", outs[2])):
        check(all(torch.equal(a, b) for a, b in zip(out, outs[0])),
              f"{name}: detections differ from the trained facade's")
    log(f"persistence d: save_model .npz and .weights, reloaded by "
        f"Yolov4(weight_path=.npz) and load_model(.weights): f32 'fast' "
        f"detections equal the trained facade's exactly (valid "
        f"{outs[0][3].tolist()}), suppress_rank launched {rl} times; "
        f"{time.perf_counter() - t_phase:.1f} s ({card})")

    # --- e. DCP round trip --------------------------------------------------
    t_phase = time.perf_counter()
    dcp_dir = root / "dcp"
    dcp_save, _ = timed(torch, lambda: ckpt.save_dcp(
        str(dcp_dir), trainer.params, trainer.state, step=trainer.global_step))
    dcp_load, (dp, ds) = timed(torch, lambda: ckpt.load_dcp(
        str(dcp_dir), trainer.global_step))
    check(ckpt.latest_dcp_step(str(dcp_dir)) == trainer.global_step,
          "latest_dcp_step does not find the DCP checkpoint")
    check(first_difference(torch, train.leaves((dp, ds)),
                           train.leaves((trainer.params, trainer.state)))
          is None and all(t.device.type == trainer.device.type
                          for t in train.leaves(dp)),
          "DCP round trip is not bit-equal on the card")
    log(f"persistence e: save_dcp / load_dcp of the trained params and BN "
        f"state on the card bit-equal, latest_dcp_step "
        f"{trainer.global_step}; {time.perf_counter() - t_phase:.1f} s")

    # --- f. what users wait for at every epoch end ---------------------------
    t_phase = time.perf_counter()
    full = root / "full.npz"
    ck_save, _ = timed(torch, lambda: trainer.save_checkpoint(str(full), 3))
    ck_restore, _ = timed(torch, lambda: fresh.restore_checkpoint(str(full)))
    sizes = {"full": file_mb(full), "npz": file_mb(npz),
             "weights": file_mb(dark), "dcp": file_mb(dcp_dir)}
    for name, secs, mb in (
            ("Trainer.save_checkpoint (params, BN state, 2 moments)",
             ck_save, sizes["full"]),
            ("Trainer.restore_checkpoint", ck_restore, sizes["full"]),
            ("save_model(.npz)", save_s[".npz"], sizes["npz"]),
            ("save_model(.weights)", save_s[".weights"], sizes["weights"]),
            ("Yolov4(weight_path=.npz) (read, fold, place)", load_s,
             sizes["npz"]),
            ("save_dcp (params, BN state)", dcp_save, sizes["dcp"]),
            ("load_dcp", dcp_load, sizes["dcp"])):
        log(f"persistence f: {name}: {secs * 1e3:.1f} ms, {mb:.1f} MB, "
            f"{mb / secs:.1f} MB/s ({card})")
    for p in (full, after_a, npz, dark, root / "ck_0.npz", root / "ck_1.npz"):
        p.unlink()
    shutil.rmtree(dcp_dir)
    # One epoch of fit without and with resume_dir (its checkpoint after
    # the epoch), in turns.
    epoch_s = {False: [], True: []}
    for with_resume in (False, True, True, False):
        e = trainer.history[-1]["epoch"] + 1
        where = root / f"epoch{e}"
        secs, _ = timed(torch, lambda: trainer.fit(
            gen, epochs=e + 1, initial_epoch=e, verbose=False,
            resume_dir=str(where) if with_resume else None))
        epoch_s[with_resume].append(secs)
        shutil.rmtree(where, ignore_errors=True)
    log(f"persistence f: fit epoch of {len(gen)} steps at b8 bf16 (JPEG "
        f"decode included), without resume_dir "
        f"{', '.join(f'{s:.3f}' for s in epoch_s[False])} s, with it "
        f"{', '.join(f'{s:.3f}' for s in epoch_s[True])} s ({card})")
    log(f"persistence f: {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(root, ignore_errors=True)
    shutil.rmtree(resume, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 7: int8 post-training quantization and AOT serving
# ---------------------------------------------------------------------------

def conv_inputs(num_classes: int, side: int = 416):
    """(conv index, input side, kernel, downsampling, Ci, Co) of every conv
    of the forward, in serial order."""
    from yolov4tpu_torch.models import network, topology

    class Trace(network._InitOps):
        def __init__(self):
            super().__init__(None)
            self.shapes = []

        def conv(self, x, filters, kernel_size, downsampling=False,
                 activation="leaky", batch_norm=True):
            self.shapes.append((len(self.specs), x.h, kernel_size,
                                downsampling, x.c, filters))
            return super().conv(x, filters, kernel_size, downsampling,
                                activation, batch_norm)

    trace = Trace()
    topology.yolov4(trace, network._ShapeVal(side, side, 3), num_classes,
                    topology.DEFAULT_CSP_REPEATS)
    return trace.shapes


def int8_gemm_phase(torch, model, card):
    """7a: the int8 conv (im2col + ``torch._int_mm``) of one quantized conv
    per kind (1x1, 3x3 stride 1, 3x3 stride 2) and input side, at b8, and
    one 1x1 product of 4 rows (padded to the 17 ``_int_mm`` takes), against
    a float64 conv of the same int8 operands: exact, every sum is an
    integer below 2^53.  Returns the cases checked."""
    import torch.nn.functional as F
    from yolov4tpu_torch.models import quantize
    rng = np.random.default_rng(7)
    first = {}
    for idx, side, k, down, ci, co in conv_inputs(model.num_classes,
                                                  model.img_size[0]):
        if "wq" in model._folded["convs"][idx]:
            first.setdefault((k, down, side), (idx, ci, co))
    cases = [(key, val, 8) for key, val in sorted(first.items())]
    cases.append(((1, False, 2), next(v for (k, _, _), v in
                                      sorted(first.items()) if k == 1), 1))
    for (k, down, side), (idx, ci, co), b in cases:
        x = torch.from_numpy(rng.integers(-127, 128, (b, side, side, ci),
                                          dtype=np.int8)).cuda().permute(
                                              0, 3, 1, 2)   # channels_last
        wq = model._folded["convs"][idx]["wq"]          # (Co, k*k*Ci)
        with torch.inference_mode():
            y, _ = quantize.int8_conv(x, wq, k, down)
            w = wq.view(co, k, k, ci).permute(0, 3, 1, 2).double()
            xd = x.double()
            ref = (F.conv2d(F.pad(xd, (1, 0, 1, 0)), w, stride=2) if down
                   else F.conv2d(xd, w, padding=k // 2))
            ref = ref.permute(0, 2, 3, 1).reshape(-1, co)
        check(y.dtype == torch.int32 and torch.equal(y.double(), ref),
              f"int8 GEMM != float64 conv: conv {idx} {k}x{k}"
              f"{' s2' if down else ''} at {side}^2, b{b}")
    log(f"int8 a: im2col + torch._int_mm int32 accumulators == float64 conv "
        f"of the same int8 operands, exactly, in {len(cases)} cases: "
        + ", ".join(f"{k}x{k}{' s2' if d else ''}@{s} b{b}"
                    for (k, d, s), _, b in cases) + f" ({card})")
    return len(cases)


def record_int8(torch, qparams, scales, images, dtype):
    """The int8 forward (int8 dataflow, s2d stem on) of ``images``: (raw
    grids, the int8 output of every quantized conv as NHWC tensors)."""
    from yolov4tpu_torch.models import quantize, topology

    outs = []

    class Recording(quantize._QuantizedFlowOps):
        def conv(self, *args, **kwargs):
            y = super().conv(*args, **kwargs)
            if isinstance(y, quantize._QVal):
                outs.append(y.q.permute(0, 2, 3, 1))
            return y

    with torch.inference_mode():
        ops = Recording(qparams, scales, dtype, s2d_stem=True)
        raws = topology.yolov4(ops, images.permute(0, 3, 1, 2), 80,
                               topology.DEFAULT_CSP_REPEATS)
    return [r.permute(0, 2, 3, 1).float() for r in raws], outs


def rel_rms(got, want) -> float:
    """RMS of the difference over the RMS of ``want`` (tensors, float64)."""
    got, want = got.double(), want.double()
    return float((got - want).square().mean().sqrt()
                 / want.square().mean().sqrt())


def box_iou(a, b) -> float:
    lo, hi = np.maximum(a[:2], b[:2]), np.minimum(a[2:], b[2:])
    inter = float(np.prod(np.clip(hi - lo, 0, None)))
    union = float(np.prod(a[2:] - a[:2]) + np.prod(b[2:] - b[:2])) - inter
    return inter / max(union, 1e-9)


def detections_agree(ref, other, label):
    """The JAX package's int8 detection contract (tests/test_quantize.py:
    128-173): per image, counts within max(3, 25%); at least 80% of the
    confident (score >= 0.10) reference boxes have a same-class box at IoU
    >= 0.5.  Returns (matched, checked)."""
    checked = matched = 0
    for i in range(int(ref[3].shape[0])):
        rb, rs, rc, rn = numpy_outputs(ref, i)
        ob, _, oc, on = numpy_outputs(other, i)
        check(abs(rn - on) <= max(3, int(0.25 * max(rn, on))),
              f"{label}: image {i} has {on} detections against {rn}")
        for j in range(rn):
            if rs[j] < 0.10:
                continue
            checked += 1
            matched += any(rc[j] == oc[k] and box_iou(rb[j], ob[k]) >= 0.5
                           for k in range(on))
    check(checked > 0 and matched >= 0.8 * checked,
          f"{label}: {matched} of {checked} confident boxes matched")
    return matched, checked


def well_conditioned_params(torch, num_classes: int = 80, seed: int = 3):
    """Full-depth (params, state) whose activations stay O(1) through the
    110 convs: unit-gain kernels, N(0, 1 / fan_in), BN at its init (unit
    scale and variance, zero mean) with shifts drawn N(0, 1), head biases
    zero; CPU tensors.  Not the JAX package's int8 test weights: its
    He-scaled kernels (N(0, 2 / fan_in), tests/test_quantize.py
    he_scaled_model) grow the activations by orders of magnitude over the
    full depth, and BN statistics taken from a batch make the forward
    chaotic (bfloat16 rounding alone decorrelates the grids), so int8
    could not be told from noise; with these, bfloat16 and int8 move the
    grids by under 1% (phase 7 prints int8's)."""
    from yolov4tpu_torch.models import network
    rng = np.random.default_rng(seed)
    convs, bn = [], []
    for spec in network.conv_specs(num_classes):
        k, ci, co = spec.kernel_size, spec.in_ch, spec.filters
        p = {"w": torch.from_numpy(rng.normal(
            0.0, np.sqrt(1.0 / (k * k * ci)), (co, ci, k, k)).astype(
                np.float32))}
        if spec.batch_norm:
            p.update(gamma=torch.ones(co), beta=torch.from_numpy(
                rng.normal(0.0, 1.0, co).astype(np.float32)))
            bn.append({"mean": torch.zeros(co), "var": torch.ones(co)})
        else:
            p["b"] = torch.zeros(co)
            bn.append(None)
        convs.append(p)
    return {"convs": convs}, {"bn": bn}


def int8_phase(torch, nms_cuda, wpath, card):
    """Phase 7a-d: int8 post-training quantization through the user's
    entry points at full depth, 416^2, COCO-80, with well-conditioned
    weights (``well_conditioned_params``) whose head biases are calibrated
    as in phase 3 so the model detects: (a) the int8 GEMM against an exact
    reference; (b) ``Yolov4.quantize`` on 16 scene images for both dataflows and both
    calibration methods, and the card's float32 scales against the CPU's;
    (c) int8 ``predict_batch`` ("fast") at b8 f32, b8 bf16 and b64 bf16,
    the card's f32 raw grids against the CPU's, and int8 against float
    detections; (d) forward and ``predict_batch`` times in turns, peak
    memory and a profiler split of one int8 b64 forward.  Returns the
    facades serving uses and the rank kernel's launches in (c)."""
    from yolov4tpu_torch import weights
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.models import network, quantize

    cfg16 = dataclasses.replace(DEFAULT_CONFIG, compute_dtype="bfloat16")
    params, state = well_conditioned_params(torch)

    def facade(config=DEFAULT_CONFIG, device="cuda"):
        # The file only seeds the constructor; the weights are replaced.
        m = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES),
                   config=config, device=device)
        m.sync_params(params, state)
        return m

    q32 = facade()
    with torch.inference_mode():
        raws = q32._raw(torch.from_numpy(scene(1, 8)).cuda().float() / 255.0)
    boxes = sum(r.shape[1] * r.shape[2] * 3 for r in raws)
    params, delta = weights.calibrate_detection_density(
        params, raws, 80, target_per_image=min(120.0, boxes / 4), spread=1.0)
    q32.sync_params(params, state)
    log(f"int8: unit-gain kernels, BN shifts N(0, 1), head biases "
        f"calibrated (delta {delta:.4f}); raw grid std "
        + ", ".join(f"{float(r.std()):.3g}" for r in raws))
    del raws
    calib = scene(11, 16).astype(np.float32) / 255.0
    f16, q8, qb = facade(cfg16), facade(cfg16), facade(cfg16)
    q32.quantize(calib_imgs=calib[:2])
    int8_gemm_phase(torch, q32, card)

    # --- b. quantize: both dataflows and both calibration methods ---------
    scales = {}
    for model, dataflow in ((q8, "int8"), (qb, "bf16")):
        for method in ("percentile", "max"):
            secs, _ = timed(torch, lambda: model.quantize(
                calib_imgs=calib, dataflow=dataflow, calib_method=method))
            scales[dataflow, method] = model._act_scales
            n_q = sum("wq" in p for p in model._folded["convs"])
            check(n_q == 105, f"{n_q} int8 convs, expected 105")
            log(f"int8 b: quantize(16 images, dataflow={dataflow!r}, "
                f"calib_method={method!r}) bf16: {secs:.2f} s, {n_q} of 110 "
                f"convs int8, conv-input scales "
                f"{float(model._act_scales['conv_in'].min()):.3g}-"
                f"{float(model._act_scales['conv_in'].max()):.3g} ({card})")
    for dataflow in ("int8", "bf16"):
        pct, mx = scales[dataflow, "percentile"], scales[dataflow, "max"]
        check(all(np.all((pct[k] > 0) & (pct[k] <= mx[k] * (1 + 1e-6)))
                  for k in mx), "percentile scales above the max-abs ones")
    cpu = facade(device="cpu")
    cpu.quantize(calib_imgs=calib[:2])
    worst = max(float(np.max(np.abs(q32._act_scales[k] / cpu._act_scales[k]
                                    - 1))) for k in cpu._act_scales)
    check(worst <= 1e-4, f"card f32 scales vs CPU: rtol {worst:.3g} > 1e-4")
    log(f"int8 b: card f32 (TF32 off) max-abs scales on 2 images vs the "
        f"CPU's: largest relative difference {worst:.3g} (limit 1e-4)")

    # --- c. int8 predict_batch, "fast" -------------------------------------
    u8 = scene(12, 8)
    f32 = u8.astype(np.float32) / 255.0
    u64 = scene(13, 64)
    nms_cuda.LAUNCHES = 0
    outs = {"int8 f32 b8": q32.predict_batch(f32),
            "int8 bf16 b8": q8.predict_batch(u8),
            "int8 bf16 b64": q8.predict_batch(u64),
            "int8-bf16 dataflow b8": qb.predict_batch(u8)}
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    check(launches == len(outs), f"suppress_rank launched {launches} times "
          f"in {len(outs)} int8 predict_batch calls")
    for name, out in outs.items():
        check(all(bool(torch.isfinite(o.float()).all()) for o in out)
              and int(out[3].min()) > 0, f"{name}: no detections or "
              f"non-finite outputs ({out[3].tolist()})")
    log(f"int8 c: {len(outs)} int8 predict_batch calls, suppress_rank "
        f"launched {launches} times; valid " + "; ".join(
            f"{k} {v[3].tolist()[:8]}" for k, v in outs.items()))
    # The card's f32 int8 forward against the CPU's, same int8 params and
    # scales, one image.
    folded = network.fold_bn(params, state)
    qp = quantize.quantize_folded(folded, q32._act_scales, 80)
    x1 = torch.from_numpy(f32[:1])
    raw_c, q_c = record_int8(torch, network.prepare_folded(qp, "cuda"),
                             q32._act_scales, x1.cuda(), torch.float32)
    raw_h, q_h = record_int8(torch, network.prepare_folded(qp, "cpu"),
                             q32._act_scales, x1, torch.float32)
    rel = max(rel_rms(a.cpu(), b) for a, b in zip(raw_c, raw_h))
    differ = sum(int((a.cpu() != b).sum()) for a, b in zip(q_c, q_h))
    total = sum(b.numel() for b in q_h)
    check(rel <= 1e-2, f"card vs CPU int8 f32 raw grids: rel-RMS {rel:.3g}")
    log(f"int8 c: card vs CPU int8 f32 forward, b1, same int8 params and "
        f"scales: raw grids rel-RMS {rel:.3g} (limit 1e-2); {differ} of "
        f"{total} int8 elements differ ({differ / total:.3g}) over "
        f"{len(q_h)} quantized convs")
    floats = f16.predict_batch(u8)
    x8 = torch.from_numpy(u8).cuda().float() / 255.0
    raw_f = f16._raw(x8)
    for name, model in (("int8-int8", q8), ("int8-bf16", qb)):
        log(f"int8 c: {name} vs float bf16 raw grids, b8: rel-RMS "
            + ", ".join(f"{rel_rms(a, b):.3g}"
                        for a, b in zip(model._raw(x8), raw_f)))
    del x8, raw_f
    for name in ("int8 bf16 b8", "int8-bf16 dataflow b8"):
        matched, checked = detections_agree(floats, outs[name], name)
        log(f"int8 c: {name} vs float bf16 b8: counts within max(3, 25%), "
            f"{matched} of {checked} confident float boxes matched at IoU "
            f">= 0.5 with the same class")
    del raw_c, q_c, raw_h, q_h, outs, cpu

    # --- d. times ------------------------------------------------------------
    rows = {bsz: collections.defaultdict(list) for bsz in (8, 64)}
    for bsz, imgs in ((8, u8), (64, u64)):
        x = torch.from_numpy(imgs).cuda().float() / 255.0
        for name, model in (("float bf16", f16), ("int8-int8", q8),
                            ("int8-bf16", qb), ("float bf16", f16)):
            torch.cuda.reset_peak_memory_stats()
            fwd = cuda_ms(lambda: model._raw(x), n=3, repeats=3)
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            rate = predict_rate(torch, model, imgs, iters=5)
            rows[bsz][name].append((fwd, rate, peak))
        log(f"int8 d: b{bsz} bf16, in turns (float, int8-int8, int8-bf16, "
            f"float): " + "; ".join(
                f"{name} forward " + ", ".join(f"{f:.3f}" for f, _, _ in v)
                + " ms, predict_batch " + ", ".join(f"{r:.1f}" for _, r, _
                                                     in v)
                + f" img/s, peak {max(p for _, _, p in v):.2f} GiB"
                for name, v in rows[bsz].items()) + f" ({card})")
    x = torch.from_numpy(u64).cuda().float() / 255.0
    split = collections.defaultdict(float)
    with torch.inference_mode():
        times = kernel_times(lambda: q8._raw(x), calls=3)
    for name, ms in times.items():
        low = name.lower()
        kind = ("int8 GEMM" if any(s in low for s in ("gemm", "imma", "xmma",
                                                      "cutlass", "sm90"))
                else "copies and casts (im2col, pad, cat)" if any(
                    s in low for s in ("copy", "cat", "pad"))
                else "elementwise and other")
        split[kind] += ms
    log(f"int8 d: profiler split of one int8-int8 b64 bf16 forward, device "
        f"ms: " + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f", sum {sum(split.values()):.3f} ({card})")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1])[:6]:
        log(f"int8 d:   {ms:.3f} ms  {name[:110]}")
    del x
    return {"f16": f16, "q8": q8, "q32": q32, "u8": u8, "f32": f32,
            "forward": rows, "split": dict(split), "launches": launches}


def serving_phase(torch, nms_cuda, models, card):
    """Phase 7e: ``serving.export_detector`` -> ``load_detector`` of the
    float bf16 "fast" program (b8, float32 input), the int8 "fast" one
    (b8, uint8 input) and the float "pallas" one (b8): each loaded
    artifact equals the live ``predict_batch`` (valid equal, boxes and
    scores within 1e-5) and launches its kernel once a call; then a
    package-free ("cuda", "cpu") "xla" artifact at b1 float32 (top 64
    candidates a class) runs on both devices within 1e-3 per box.  Returns
    the kernels' launches."""
    import copy
    from yolov4tpu_torch import serving
    f16, q8, q32, u8, f32 = (models[k] for k in
                             ("f16", "q8", "q32", "u8", "f32"))
    pallas = copy.copy(f16)
    pallas.config = dataclasses.replace(f16.config, nms_impl="pallas")
    pallas.sync_params(pallas.params, pallas.state)
    # The plain exact NMS unrolls its loop over each class's candidates
    # into the program: 64 of them keep the export short.
    xla = copy.copy(q32)
    xla.config = dataclasses.replace(q32.config, nms_impl="xla",
                                     nms_pre_top_k=64)
    xla.dequantize()
    root = SCRATCH / "serving"
    root.mkdir(parents=True, exist_ok=True)
    launches = {"suppress_rank": 0, "suppress": 0}
    for name, model, images, kw, counter in (
            ("float bf16 'fast' b8 float32", f16, f32, {}, "LAUNCHES"),
            ("int8 bf16 'fast' b8 uint8", q8, u8,
             {"input_dtype": "uint8"}, "LAUNCHES"),
            ("float bf16 'pallas' b8 float32", pallas, f32, {},
             "SUPPRESS_LAUNCHES")):
        path = root / "artifact.pt2"
        total, exported = timed(torch, lambda: serving.export_detector(
            model, str(path), batch_size=8, **kw))
        save, _ = timed(torch, lambda: torch.export.save(
            exported, str(root / "again.pt2")))
        load, detect = timed(torch, lambda: serving.load_detector(str(path)))
        setattr(nms_cuda, counter, 0)
        got = detect(images)
        torch.cuda.synchronize()
        calls = getattr(nms_cuda, counter)
        want = model.predict_batch(images)
        check(calls == 1, f"{name}: the loaded artifact launched its kernel "
              f"{calls} times in one call")
        key = "suppress_rank" if counter == "LAUNCHES" else "suppress"
        launches[key] += calls
        check(torch.equal(got[3], want[3]) and all(
            float((g.float() - w.float()).abs().max()) <= 1e-5
            for g, w in zip(got[:3], want[:3])),
            f"{name}: the loaded artifact differs from predict_batch")
        rates = []
        for fn in (lambda: detect(images),
                   lambda: model.predict_batch(images)):
            for _ in range(2):
                fn()
            secs, _ = timed(torch, lambda: [fn() for _ in range(10)])
            rates.append(80 / secs)
        log(f"serving: {name}: export {total - save:.2f} s, save {save:.2f} "
            f"s, {file_mb(path):.1f} MB, load {load:.2f} s; loaded == "
            f"predict_batch (valid {got[3].tolist()}), kernel launched once "
            f"a call; {rates[0]:.1f} img/s loaded vs {rates[1]:.1f} "
            f"predict_batch ({card})")
        del exported, detect
    path = root / "package_free.pt2"
    total, exported = timed(torch, lambda: serving.export_detector(
        xla, str(path), batch_size=1, platforms=("cuda", "cpu")))
    check(not [n for n in exported.graph.nodes
               if "yolov4tpu" in str(n.target)],
          "the two-platform artifact holds an op of the port")
    on_card = serving.load_detector(str(path))(f32[:1])
    on_cpu = serving.load_detector(str(path), device="cpu")(f32[:1])
    want = xla.predict_batch(f32[:1])
    check(torch.equal(on_card[3], want[3]) and all(
        float((g - w).abs().max()) <= 1e-5
        for g, w in zip(on_card[:3], want[:3])),
        "the two-platform artifact differs from predict_batch on the card")
    dev = match_detections(numpy_outputs(on_card, 0), numpy_outputs(on_cpu, 0),
                           1e-3)
    log(f"serving: package-free ('cuda', 'cpu') 'xla' f32 b1 artifact: no "
        f"op of the port, {file_mb(path):.1f} MB, export + save "
        f"{total:.2f} s; card == predict_batch; card vs CPU "
        f"{int(want[3][0])} detections, max deviation {dev:.3g} (limit "
        f"1e-3)")
    import shutil
    shutil.rmtree(root, ignore_errors=True)
    return launches


# ---------------------------------------------------------------------------
# Augmented ingest and multi-scale training
# ---------------------------------------------------------------------------

# Photo sizes (h, w) of the ingest data set: VGA to full HD.
PHOTO_SIZES = ((480, 640), (600, 800), (768, 1024), (720, 1280),
               (900, 1200), (1080, 1920))
# Seed of the main path's generator: over its 10 batches (40 images, b8,
# 2 epochs) it draws 608, 448, 608, 576, 448, 544, 416, 416, 320, 576.
MULTISCALE_SEED = 7


def exif_rotated(jpeg: bytes, orientation: int = 6) -> bytes:
    """The JPEG with a minimal EXIF APP1 segment (little-endian TIFF, one
    IFD0 entry: the orientation tag) right after its SOI marker."""
    tiff = (b"II" + (0x2A).to_bytes(2, "little") + (8).to_bytes(4, "little")
            + (1).to_bytes(2, "little")
            + (0x0112).to_bytes(2, "little") + (3).to_bytes(2, "little")
            + (1).to_bytes(4, "little")
            + orientation.to_bytes(2, "little") + b"\x00\x00"
            + (0).to_bytes(4, "little"))
    payload = b"Exif\x00\x00" + tiff
    app1 = b"\xff\xe1" + (len(payload) + 2).to_bytes(2, "big") + payload
    return jpeg[:2] + app1 + jpeg[2:]


def write_photo_set(folder: pathlib.Path, n: int = 38, seed: int = 8,
                    sizes=PHOTO_SIZES):
    """n JPEGs at photo sizes with 1-8 boxes each, one PNG, and one JPEG
    whose EXIF orientation is 6 (cv2 rotates it, the native decoder refuses
    it: both are redone in Python), with their annotation file -> its
    lines."""
    import cv2
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    names = [f"photo{i}.jpg" for i in range(n)] + ["photo.png", "exif6.jpg"]
    lines = []
    for i, name in enumerate(names):
        h, w = sizes[i % len(sizes)]
        coarse = rng.uniform(0, 255, (h // 32, w // 32, 3)).astype(np.float32)
        img = cv2.resize(coarse, (w, h)) + rng.normal(0, 12, (h, w, 3))
        img = np.clip(img, 0, 255).astype(np.uint8)
        path = folder / name
        cv2.imwrite(str(path), img)
        if name == "exif6.jpg":
            path.write_bytes(exif_rotated(path.read_bytes()))
            h, w = w, h              # boxes in the displayed (rotated) frame
        boxes = []
        for _ in range(int(rng.integers(1, 9))):
            x1 = int(rng.integers(0, w - w // 8))
            y1 = int(rng.integers(0, h - h // 8))
            x2 = int(rng.integers(x1 + w // 16, min(x1 + w // 2, w)))
            y2 = int(rng.integers(y1 + h // 16, min(y1 + h // 2, h)))
            boxes.append(f"{x1},{y1},{x2},{y2},{int(rng.integers(0, 80))}")
        lines.append(f"{name} " + " ".join(boxes))
    (folder / "annotations.txt").write_text("\n".join(lines) + "\n")
    return lines


def route_counts():
    """(native plain batches, native augmented batches, Python batches,
    samples redone in Python) so far."""
    from yolov4tpu_torch import native
    from yolov4tpu_torch.data import pipeline
    return (native.NATIVE_BATCHES, native.NATIVE_AUG_BATCHES,
            pipeline.PYTHON_BATCHES, pipeline.PYTHON_REDO_SAMPLES)


def since(before):
    return tuple(a - b for a, b in zip(route_counts(), before))


AUGMENTED = dict(use_mosaic=True, use_hflip=True, use_color_jitter=True)


def native_build_phase(card):
    """Phase 8a: a fresh build of the native ingest library in a new
    process (its seconds), and the variant this process loaded."""
    import os
    import tempfile

    from yolov4tpu_torch import native
    code = ("import pathlib, sys, time\n"
            "from yolov4tpu_torch import native\n"
            "native.BUILD_DIR = pathlib.Path(sys.argv[1])\n"
            "t0 = time.perf_counter()\n"
            "ok = native.available()\n"
            "print(ok, native.build_variant(), time.perf_counter() - t0)\n")
    with tempfile.TemporaryDirectory(dir=SCRATCH) as tmp:
        proc = subprocess.run([sys.executable, "-c", code, tmp], cwd=ROOT,
                              capture_output=True, text=True, timeout=600,
                              check=True)
    ok, fresh_variant, secs = proc.stdout.split()
    check(ok == "True", f"the native library did not build: {proc.stderr}")
    check(native.available(), "the native library did not load")
    variant = native.build_variant()
    check(variant == fresh_variant, f"this process loaded {variant}, a "
          f"fresh build gave {fresh_variant}")
    for name, extra in native.VARIANTS:
        if name == variant:
            break
        errors = [line for line in native.variant_path(extra).with_suffix(
            ".log").read_text().splitlines() if "error" in line]
        log(f"native variant {name} did not build: "
            f"{errors[0] if errors else 'no error line'}")
    log(f"native ingest library: variant {variant} (libjpeg "
        f"{native.has_jpeg()}), {native.library_path().name}; a fresh g++ "
        f"build of it took {float(secs):.2f} s; host os.cpu_count() "
        f"{os.cpu_count()}, the library's OpenMP threads "
        f"{native.num_threads()}, torch intra-op threads "
        f"{__import__('torch').get_num_threads()} ({card})")
    return variant


def ingest_checks(native, folder, lines, size: int, workers: int):
    """Phase 8c: at size^2 b8, native against Python with the same seed:
    boxes and label grids bit-equal, images within the JAX tests' bounds
    (tests/test_pipeline.py:431 for the plain fused ingest at full decode,
    :534-536 for the augmented one); two native runs bit-equal; the pool
    equal to the sequential Python path.  Asserts the route the build
    variant implies with the counters."""
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator
    cases = {"plain (exact decode)": dict(fast_decode=False),
             "mosaic+hflip+jitter": AUGMENTED,
             "letterbox+hflip": dict(letterbox=True, use_hflip=True),
             "jitter": dict(use_color_jitter=True)}
    for name, aug in cases.items():
        plain = name.startswith("plain")
        cfg = dataclasses.replace(DEFAULT_CONFIG, img_size=(size, size, 3),
                                  num_workers=workers, **aug)
        gn, gp = (DataGenerator(lines, str(CLASSES), str(folder), config=cfg,
                                seed=3, use_native=use) for use in (True,
                                                                    False))
        before = route_counts()
        worst = 0.0
        for i in range(len(gn)):
            bn = gn.get_batch(i)
            mid = route_counts()
            bp = gp.get_batch(i)
            check(route_counts()[2] == mid[2] + 1, f"{name}: the Python "
                  f"generator did not take the Python path")
            check(np.array_equal(bn["boxes"], bp["boxes"]) and all(
                np.array_equal(a, b) for a, b in zip(bn["labels"],
                                                     bp["labels"])),
                  f"{name}: boxes or label grids differ from the Python "
                  f"path's")
            diff = np.abs(bn["image"] - bp["image"])
            lo, hi = float(bn["image"].min()), float(bn["image"].max())
            if plain:   # tests/test_pipeline.py:431
                err = float(diff.max())
                check(err < 2.5 / 255, f"{name}: images differ by {err}")
            else:       # tests/test_pipeline.py:534-536
                err = float(diff.mean())
                check(err < 0.08 and lo >= 0 and hi <= 1, f"{name}: images "
                      f"differ by {err} on average, range [{lo}, {hi}]")
            worst = max(worst, err)
        d = since(before)
        want = ((len(gn), 0) if plain else (0, len(gn))) \
            if native.has_jpeg() else (0, 0)
        check(d[:2] == want, f"{name}: native batches {d[:2]}, want {want} "
              f"from the {native.build_variant()} build")
        log(f"ingest {size}^2 b8 {name}: native == Python path for "
            f"{len(gn)} batches (boxes and label grids bit-equal, images "
            f"{'max' if plain else 'mean'} abs diff up to {worst:.4f}); "
            f"routes native plain {d[0]}, native augmented {d[1]}, Python "
            f"{d[2] - len(gn)}, samples redone in Python {d[3]}")
    cfg = dataclasses.replace(DEFAULT_CONFIG, img_size=(size, size, 3),
                              num_workers=workers, **AUGMENTED)
    runs = [DataGenerator(lines, str(CLASSES), str(folder), config=cfg,
                          seed=5).get_batch(0) for _ in range(2)]
    check(all(np.array_equal(runs[0][k], runs[1][k])
              for k in ("image", "boxes"))
          and all(np.array_equal(a, b) for a, b in
                  zip(runs[0]["labels"], runs[1]["labels"])),
          "two native augmented runs differ")
    pools = [DataGenerator(lines, str(CLASSES), str(folder), seed=5,
                           use_native=False,
                           config=dataclasses.replace(cfg, num_workers=w))
             for w in (1, workers)]
    a, b = (g.get_batch(0) for g in pools)
    check(np.array_equal(a["image"], b["image"])
          and np.array_equal(a["boxes"], b["boxes"]),
          f"the Python pool of {workers} workers != the sequential path")
    for g in pools:
        g.close()
    log(f"ingest {size}^2 b8 mosaic+hflip+jitter: two native runs bit-equal; "
        f"the Python pool of {workers} workers == the sequential path")


def ingest_rates(native, folder, lines, size: int, workers: int, card):
    """Phase 8d: host ingest img/s at size^2 b8, median of three epochs, for
    each augmentation on each route; the counters say which route made the
    batches."""
    import os
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator
    cells = {"plain": {}, "mosaic+hflip+jitter": AUGMENTED,
             "letterbox+hflip+jitter": dict(letterbox=True, use_hflip=True,
                                            use_color_jitter=True),
             "cutmix": dict(use_cutmix=True)}
    routes = {"Python sequential": (False, 1),
              f"Python pool ({workers} workers)": (False, workers),
              f"native ({native.num_threads()} OpenMP threads)":
                  (True, workers)}
    rates = {}
    for cell, aug in cells.items():
        for route, (use, w) in routes.items():
            cfg = dataclasses.replace(DEFAULT_CONFIG, num_workers=w,
                                      img_size=(size, size, 3), **aug)
            gen = DataGenerator(lines, str(CLASSES), str(folder), config=cfg,
                                seed=4, use_native=use)
            before = route_counts()
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                for i in range(len(gen)):
                    gen.get_batch(i)
                runs.append(len(lines) / (time.perf_counter() - t0))
                gen.on_epoch_end()
            gen.close()
            d = since(before)
            decode = "native" if native.has_jpeg() else "cv2"
            made = ("native plain ingest" if d[0] else
                    "native augmented ingest" if d[1] else
                    "the Python path" if not use else
                    f"the Python pool ({decode} decode)" if d[2] else
                    "cv2 decode + the native resize")
            rate = statistics.median(runs)
            rates[(cell, route)] = rate
            log(f"ingest rate {size}^2 b8 {cell}, {route}: {rate:.1f} img/s "
                f"(median of {', '.join(f'{r:.1f}' for r in runs)}; "
                f"{3 * len(gen)} batches made by {made}, {d[3]} samples "
                f"redone in Python; host {os.cpu_count()} cores; {card})")
    return rates


def multiscale_fit_phase(torch, wgrad_cuda, nms_cuda, wpath, folder, lines,
                         card, workers: int, base: int = 416,
                         scales=(320, 608), batch: int = 8):
    """Phase 8e, the slice's main path: ``Yolov4(pallas_wgrad=True)`` in
    bf16 at full depth, COCO-80, random darknet weights, ``fit`` 2 epochs
    at b8 over the native augmented generator (mosaic, hflip, colour
    jitter, multi-scale redrawn every batch), each step timed; then
    ``predict_batch`` at the base size on the trained weights.  Returns
    (wgrad launches, suppress_rank launches)."""
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator
    from yolov4tpu_torch.native import has_jpeg

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, pallas_wgrad=True, compute_dtype="bfloat16",
        img_size=(base, base, 3), batch_size=batch, num_workers=workers,
        multi_scale=scales, multi_scale_interval=1, **AUGMENTED)
    gen = DataGenerator(lines, str(CLASSES), str(folder), config=cfg,
                        seed=MULTISCALE_SEED)
    check(gen.use_native, "the generator did not load the native library")
    model = Yolov4(weight_path=str(wpath), class_name_path=str(CLASSES),
                   config=cfg)
    trainer = model.trainer()
    inner = trainer.train_step
    steps = []

    def timed_step(b):
        start = time.perf_counter()
        metrics = inner(b)
        loss = float(metrics["loss"])
        torch.cuda.synchronize()
        steps.append((int(b["image"].shape[1]), start, time.perf_counter(),
                      loss))
        return metrics

    trainer.train_step = timed_step
    torch.cuda.reset_peak_memory_stats()
    before = route_counts()
    wgrad_cuda.LAUNCHES = wgrad_cuda.TC_LAUNCHES = 0
    t0 = time.perf_counter()
    history = model.fit(gen, epochs=2, verbose=False)
    torch.cuda.synchronize()
    launches, tc = wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    d = since(before)
    gen.close()
    sizes = [s for s, _, _, _ in steps]
    per_step = {s: sum(wgrad_shapes(s).values()) for s in set(sizes)}
    check(len(steps) == 2 * len(gen), f"fit ran {len(steps)} steps")
    check(set(per_step.values()) == {37}, f"3x3 stride-1 convs per size "
          f"{per_step}, not 37")
    check(launches == tc == 37 * len(steps), f"wgrad launched {launches} "
          f"times ({tc} on the tensor cores) in {len(steps)} steps, not "
          f"{37 * len(steps)}")
    check(len(set(sizes)) >= 3, f"only the sizes {sorted(set(sizes))} drawn")
    check(all(np.isfinite(l) for *_, l in steps)
          and all(np.isfinite(h["loss"]) for h in history),
          f"non-finite loss: {[l for *_, l in steps]}")
    if has_jpeg():
        check(d[1] == len(steps) and d[0] == 0 and d[2] == 0,
              f"routes {d}: every batch should be native augmented")
        check(d[3] >= 4, f"only {d[3]} samples redone in Python: the PNG "
              f"and the EXIF JPEG are each one sample's image every epoch")
    else:
        check(d[2] == len(steps) and d[:2] == (0, 0), f"routes {d}: without "
              f"libjpeg every augmented batch takes the Python pool")
    gaps = [steps[0][1] - t0] + [b[1] - a[2] for a, b in
                                 zip(steps, steps[1:])]
    busy = sum(e - s for _, s, e, _ in steps)
    log(f"main path (multi-scale training): fit 2 epochs x {len(gen)} steps "
        f"at b{batch} bf16, pallas_wgrad, mosaic+hflip+jitter, multi_scale="
        f"{scales} every batch: sizes drawn {sizes} ({len(set(sizes))} "
        f"distinct); wgrad launched {launches} times ({tc} on the tensor "
        f"cores, 37 a step at every size); routes: native augmented "
        f"batches {d[1]} (samples redone in Python {d[3]}), Python batches "
        f"{d[2]}; losses "
        f"{[round(l, 1) for *_, l in steps]}; fit {fit_s:.1f} s, steps "
        f"{busy:.1f} s, waits on the host {sum(gaps):.2f} s (first "
        f"{gaps[0]:.2f} s, then {sum(gaps[1:]):.2f} s); peak memory "
        f"{peak:.1f} GiB ({card})")
    for s in sorted(set(sizes)):
        times = [1e3 * (e - b) for z, b, e, _ in steps if z == s]
        steady = (f"steady {statistics.median(times[1:]):.1f} ms "
                  f"({len(times) - 1})" if len(times) > 1 else "no steady "
                  "step")
        log(f"  {s}x{s}: first step {times[0]:.1f} ms, {steady}; "
            f"{batch * 1e3 / times[-1]:.1f} img/s at its last step")

    u8 = scene(12, 8, base)
    nms_cuda.LAUNCHES = 0
    boxes, scores, classes, valid = model.predict_batch(u8)
    torch.cuda.synchronize()
    rl = nms_cuda.LAUNCHES
    check(rl == 1, f"suppress_rank launched {rl} times in one predict_batch")
    check(tuple(boxes.shape) == (8, 100, 4) and all(
        bool(torch.isfinite(o.float()).all())
        for o in (boxes, scores, classes, valid)),
        "predict_batch after the multi-scale fit")
    log(f"predict_batch {base}^2 on the trained weights: finite, valid "
        f"{valid.tolist()}, suppress_rank launched {rl} time")
    del model, trainer
    torch.cuda.empty_cache()
    return launches, rl


def wgrad_sizes_phase(torch, wgrad_cuda, card, sides=(320, 608)):
    """Phase 8f: the wgrad kernel against its plain version at every shape
    of the training path at each side (b8, float32 and bfloat16), and its
    per-step device time beside cuDNN's and the bound (``wgrad_times``).
    Returns (the per-step times by side, the largest bf16 abs error)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    out, worst_all = {}, 0.0
    for side in sides:
        shapes = wgrad_shapes(side)
        check(sum(shapes.values()) == 37, f"{side}: {dict(shapes)}")
        worst = wgrad_shape_checks(torch, wgrad_cuda, shapes, gen)
        step = wgrad_times(torch, wgrad_cuda, shapes, card)
        log(f"wgrad at {side}^2: {len(shapes)} shapes, largest bf16 abs err "
            f"{worst:.3g}; per b8 bf16 step kernel {step['ms']:.3f} ms, "
            f"cuDNN {step['library_ms']:.3f} ms, bound "
            f"{step['bound_ms']:.4f} ms ({card})")
        out[str(side)] = {k: step[k] for k in ("ms", "library_ms",
                                                "bound_ms", "plain_ms")}
        worst_all = max(worst_all, worst)
    return out, worst_all


def starvation_phase(torch, wgrad_cuda, wpath, folder, lines, card,
                     workers: int, size: int = 416, batch: int = 32,
                     steps: int = 10):
    """Phase 8g: does the host starve the step?  At b32 bf16 with the
    kernel, the train step's img/s on one batch already on the card against
    ``fit`` over the native augmented generator (prefetch thread, pinned
    copies), and the share of that epoch the card waits on the host:
    1 - steps x on-card step time / epoch time.  Returns the wgrad
    launches."""
    from yolov4tpu_torch import train, weights
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    from yolov4tpu_torch.data.pipeline import DataGenerator

    cfg = dataclasses.replace(
        DEFAULT_CONFIG, pallas_wgrad=True, compute_dtype="bfloat16",
        img_size=(size, size, 3), batch_size=batch, num_workers=workers,
        **AUGMENTED)
    many = (lines * (-(-steps * batch // len(lines))))[:steps * batch]
    gen = DataGenerator(many, str(CLASSES), str(folder), config=cfg, seed=11)
    p0, s0 = weights.load_darknet_weights(str(wpath), 80)
    wgrad_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    for i in range(3):
        gen.get_batch(i)
    ingest = 3 * batch / (time.perf_counter() - t0)
    # The step on one batch on the card, warmed up; a second trainer from
    # the same weights then fits (the allocator's cache is warm, and its
    # weights have not trained on one batch 7 times).
    trainer = train.Trainer(cfg, 80, p0, s0)
    dev = trainer._place(train.tree_map(torch.as_tensor, gen.get_batch(3)))
    for _ in range(2):
        trainer.train_step(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        trainer.train_step(dev)
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / 5
    del trainer, dev
    trainer = train.Trainer(cfg, 80, p0, s0)
    calls = []
    inner = trainer.train_step
    trainer.train_step = lambda b: (calls.append(time.perf_counter()),
                                    inner(b))[1]
    gen.on_epoch_end()
    before = route_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = trainer.fit(gen, epochs=1, verbose=False)
    torch.cuda.synchronize()
    epoch_s = time.perf_counter() - t0
    fill = calls[0] - t0
    d = since(before)
    gen.close()
    check(np.isfinite(history[-1]["loss"]), f"loss {history}")
    check(wgrad_cuda.LAUNCHES == 37 * (7 + steps), f"wgrad launched "
          f"{wgrad_cuda.LAUNCHES} times in {7 + steps} steps")
    starved = max(0.0, 1 - steps * step_s / epoch_s)
    after_fill = max(0.0, 1 - steps * step_s / (epoch_s - fill))
    log(f"host vs step at b{batch} {size}^2 bf16 pallas_wgrad, "
        f"mosaic+hflip+jitter: ingest alone {ingest:.1f} img/s; the step "
        f"on a batch on the card {batch / step_s:.1f} img/s "
        f"({1e3 * step_s:.1f} ms); fit over prefetch of the generator "
        f"(use_native=True; native augmented batches {d[1]}, Python "
        f"batches {d[2]}) {steps * batch / epoch_s:.1f} img/s ({steps} steps "
        f"in {epoch_s:.2f} s, the first batch ready after {fill:.2f} s); the "
        f"card waits on the host {starved:.1%} of the epoch, "
        f"{after_fill:.1%} after the first batch ({card})")
    del trainer
    torch.cuda.empty_cache()
    return wgrad_cuda.LAUNCHES


def ingest_phase(torch, wgrad_cuda, nms_cuda, wpath, card):
    """Phase 8: the augmented ingest and multi-scale training.  Returns the
    kernels' launches, the wgrad kernel's per-step times at 320^2 and 608^2
    and its largest bf16 error there."""
    import os

    from yolov4tpu_torch import native
    workers = os.cpu_count() or 1
    t = time.perf_counter()
    native_build_phase(card)
    folder = SCRATCH / "photos"
    lines = write_photo_set(folder)
    log(f"phase 8b: {len(lines)} images written "
        f"({time.perf_counter() - t:.1f} s with 8a)")
    t = time.perf_counter()
    ingest_checks(native, folder, lines, 416, workers)
    log(f"phase 8c: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ingest_rates(native, folder, lines, 416, workers, card)
    log(f"phase 8d: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wl, rl = multiscale_fit_phase(torch, wgrad_cuda, nms_cuda, wpath, folder,
                                  lines, card, workers)
    log(f"phase 8e: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    by_size, worst = wgrad_sizes_phase(torch, wgrad_cuda, card)
    log(f"phase 8f: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    wl += starvation_phase(torch, wgrad_cuda, wpath, folder, lines, card,
                           workers)
    log(f"phase 8g: {time.perf_counter() - t:.1f} s")
    return {"wgrad": wl, "suppress_rank": rl, "wgrad_by_size": by_size,
            "wgrad_err": worst}


# ---------------------------------------------------------------------------
# Data-parallel training: NCCL at world size 1, two gloo ranks on one card
# ---------------------------------------------------------------------------

def dp_config(**kw):
    """The data-parallel phase's model: full depth, 416^2, COCO-80, bf16,
    ``pallas_wgrad=True``."""
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    return dataclasses.replace(DEFAULT_CONFIG, pallas_wgrad=True,
                               compute_dtype="bfloat16", **kw)


class CountedSlab:
    """Wraps ``train._allreduce_slab`` (the one collective of a mesh step)
    to count its calls and time each on the host clock, the card drained
    before and after; ``close()`` puts the helper back."""

    def __init__(self, torch, train):
        self.torch, self.train = torch, train
        self.real = train._allreduce_slab
        self.calls, self.ms = 0, []
        train._allreduce_slab = self

    def __call__(self, *args):
        self.torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.real(*args)
        self.torch.cuda.synchronize()
        self.ms.append(1e3 * (time.perf_counter() - t0))
        self.calls += 1
        return out

    def close(self):
        self.train._allreduce_slab = self.real


def all_tensors(trainer):
    """A trainer's params then BN state, as a list of tensors."""
    from yolov4tpu_torch import train
    return train.leaves(trainer.params) + train.leaves(trainer.state)


def slab_split(torch, trainer, batch, repeats: int = 5):
    """The slab of one mesh step on ``batch``: its MB and the median ms
    (CUDA events) of its pack, all-reduce and unpack on this step's
    gradients, BN state and metrics."""
    import torch.distributed as dist

    from yolov4tpu_torch import train
    local = train._local_grads(80, trainer.config, masked=False)
    *parts, w = local(trainer.params, trainer.state, trainer._place(batch))
    tensors = [t for p in parts for t in train.leaves(p)]
    times = []
    for _ in range(repeats + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        flat = train._pack(tensors, w)
        ev[1].record()
        dist.all_reduce(flat, group=trainer.mesh.group)
        ev[2].record()
        train._unpack(flat, tensors)
        ev[3].record()
        torch.cuda.synchronize()
        times.append([ev[i].elapsed_time(ev[i + 1]) for i in range(3)])
    split = [statistics.median(t[i] for t in times[1:]) for i in range(3)]
    return flat.numel() * 4 / 1e6, split


def nccl_phase(torch, wgrad_cuda, wpath, folder, lines, card, per_step):
    """Phase 9a, NCCL at world size 1 in this process: a mesh ``Trainer``
    against a plain one from the same weights over 2 b8 steps (bit-equal,
    cuDNN deterministic; one rank's all-reduce is a copy and x * 8 / 8 is
    exact), one all-reduce and 37 tensor-core wgrad launches a step, the
    two-phase step bit-equal to the fused one, then the b32 step's img/s
    with and without the mesh in turns and the slab's split.  Returns the
    wgrad launches of the mesh run and the rates."""
    import torch.distributed as dist

    from yolov4tpu_torch import train, weights
    from yolov4tpu_torch.data.pipeline import DataGenerator
    from yolov4tpu_torch.parallel import init_distributed, make_mesh

    info = init_distributed(num_processes=1, process_id=0)
    check(info["backend"] == "nccl" and info["num_processes"] == 1,
          f"init_distributed: {info}")
    mesh = make_mesh(1)
    check(mesh.device.type == "cuda", f"the mesh is on {mesh.device}")
    cfg = dp_config()
    p0, s0 = weights.load_darknet_weights(str(wpath), 80)
    gen = DataGenerator(lines, str(CLASSES), str(folder), config=cfg, seed=0)
    batches = [gen.get_batch(i) for i in range(2)]

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    plain = train.Trainer(cfg, 80, p0, s0)
    for b in batches:
        plain.train_step(b)
    meshed = train.Trainer(cfg, 80, p0, s0, mesh=mesh)
    slab = CountedSlab(torch, train)
    collectives = []
    real_all_reduce = dist.all_reduce

    def counted_all_reduce(*a, **k):
        collectives.append(1)
        return real_all_reduce(*a, **k)

    dist.all_reduce = counted_all_reduce
    try:
        wgrad_cuda.LAUNCHES = wgrad_cuda.TC_LAUNCHES = 0
        for b in batches:
            meshed.train_step(b)
        torch.cuda.synchronize()
        launches, tc = wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES
    finally:
        dist.all_reduce = real_all_reduce
        slab.close()
    steps = len(batches)
    check(slab.calls == steps and len(collectives) == steps,
          f"{slab.calls} slabs and {len(collectives)} all_reduce calls in "
          f"{steps} mesh steps")
    check(launches == per_step * steps and tc == launches,
          f"wgrad launched {launches} times ({tc} on the tensor cores) in "
          f"{steps} mesh steps, not {per_step} a step")
    diff = first_difference(torch, all_tensors(meshed), all_tensors(plain))
    check(diff is None, f"mesh trainer != plain trainer after {steps} "
          f"steps: {diff}")
    log(f"9a NCCL world size 1: mesh Trainer == plain Trainer bit for bit "
        f"after {steps} b8 steps ({len(all_tensors(plain))} tensors); "
        f"all_reduce {len(collectives)} in {steps} steps; wgrad {launches} "
        f"launches, {tc} on the tensor cores")
    del plain, meshed

    fused = train.Trainer(cfg, 80, p0, s0, mesh=mesh)
    fused.train_step(batches[0])
    two = train.Trainer(cfg, 80, p0, s0, mesh=mesh)
    step = train.make_train_step_twophase(80, cfg, two.optimizer, mesh)
    two.state, _ = step(two.params, two.state, two._place(batches[0]))
    diff = first_difference(torch, all_tensors(two), all_tensors(fused))
    check(diff is None, f"twophase != fused after one step: {diff}")
    log("9a make_train_step_twophase == the fused mesh step bit for bit "
        "after one b8 step")
    del fused, two
    torch.backends.cudnn.deterministic = False
    torch.cuda.empty_cache()

    b32 = train.tree_map(lambda *xs: np.concatenate(xs), *(
        DataGenerator(lines, str(CLASSES), str(folder), config=cfg,
                      seed=9).get_batch(i) for i in (0, 1, 0, 1)))
    rates = {}
    for on_mesh in (True, False, False, True):
        trainer = train.Trainer(dp_config(batch_size=32), 80, p0, s0,
                                mesh=mesh if on_mesh else None)
        dev = trainer._place(train.tree_map(torch.as_tensor, b32))
        for _ in range(2):
            trainer.train_step(dev)
        torch.cuda.synchronize()
        iters = 5
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer.train_step(dev)
        torch.cuda.synchronize()
        rate = iters * 32 / (time.perf_counter() - t0)
        rates.setdefault(on_mesh, []).append(rate)
        if on_mesh and len(rates[True]) == 1:
            mb, split = slab_split(torch, trainer, b32)
        del trainer, dev
        torch.cuda.empty_cache()
    log(f"9a b32 bf16 train step, in turns (mesh, plain, plain, mesh): "
        f"{rates[True][0]:.1f}, {rates[False][0]:.1f}, {rates[False][1]:.1f},"
        f" {rates[True][1]:.1f} img/s ({card})")
    log(f"9a the b32 slab: {mb:.1f} MB; pack {split[0]:.3f} ms, NCCL "
        f"all_reduce {split[1]:.3f} ms, unpack {split[2]:.3f} ms (CUDA "
        f"events, median of 5; {card})")
    return launches, {"mesh_img_s": rates[True], "plain_img_s":
                      rates[False], "slab_mb": mb, "slab_ms": split}


def dp_worker(rank: int, work: pathlib.Path) -> int:
    """One rank of phase 9b (``python3 chip_smoke.py --dp-worker RANK
    DIR``): joins a gloo group of two ranks on the card through a FileStore
    in DIR, trains ``Yolov4(num_devices=2, batch_size=4).fit`` for one epoch
    over 15 of phase 5's JPEGs (b8, then a ragged 7) with a 7-line ragged
    validation set and ``CheckpointCallback``, runs ``predict_batch`` on one
    b8 scene, and writes DIR/rank<R>.json: per step the wgrad launches (all
    and tensor-core), the slabs and the seconds, the slabs' ms, the
    ``suppress_rank`` launches of the predict, and a digest of the final
    params and BN state."""
    import hashlib

    import torch
    import torch.distributed as dist

    from yolov4tpu_torch import train
    from yolov4tpu_torch.api import Yolov4
    from yolov4tpu_torch.callbacks import CheckpointCallback
    from yolov4tpu_torch.data.pipeline import DataGenerator
    from yolov4tpu_torch.ops import nms_cuda, wgrad_cuda
    from yolov4tpu_torch.parallel import init_distributed

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    info = init_distributed(f"file://{work / 'store'}", 2, rank,
                            backend="gloo")
    folder = SCRATCH / "train"
    lines = (folder / "annotations.txt").read_text().splitlines()
    cfg = dp_config(num_devices=2, batch_size=4)
    model = Yolov4(weight_path=str(SCRATCH / "random80.weights"),
                   class_name_path=str(CLASSES), config=cfg)
    trainer = model.trainer()
    slab = CountedSlab(torch, train)
    steps = []
    real_step = trainer.train_step

    def counted_step(batch):
        before = (wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES, slab.calls)
        t0 = time.perf_counter()
        metrics = real_step(batch)
        torch.cuda.synchronize()
        steps.append({"wgrad": wgrad_cuda.LAUNCHES - before[0],
                      "tc": wgrad_cuda.TC_LAUNCHES - before[1],
                      "slabs": slab.calls - before[2],
                      "s": time.perf_counter() - t0})
        return metrics

    trainer.train_step = counted_step
    gen = DataGenerator(lines[:15], str(CLASSES), str(folder), config=cfg,
                        seed=0)
    val = DataGenerator(lines[9:16], str(CLASSES), str(folder), config=cfg,
                        seed=1, shuffle=False)
    ck = CheckpointCallback(str(work / f"ck_r{rank}_{{epoch}}.npz"))
    history = model.fit(gen, epochs=1, val_data_gen=val, callbacks=[ck],
                        verbose=False)
    slab.close()
    nms_cuda.LAUNCHES = 0
    out = model.predict_batch(scene(3, 8))
    torch.cuda.synchronize()
    predict_launches = nms_cuda.LAUNCHES
    digest = hashlib.sha256()
    for t in all_tensors(trainer):
        digest.update(t.detach().cpu().numpy().tobytes())
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "info": info, "steps": steps, "slab_ms": slab.ms,
        "history": history, "predict_launches": predict_launches,
        "valid": out[3].tolist(), "digest": digest.hexdigest(),
        "masked_step": trainer._step_masked is not None,
        "masked_eval": trainer._eval_masked is not None,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}))
    dist.destroy_process_group()
    return 0


def dp_emulation(torch, wpath, folder, lines, device="cuda"):
    """Phase 9b's two steps emulated in this process on the card: the same
    seeded batches, each rank's rows (the ragged 7 padded to 8 with a mask)
    through the gradient core, combined as the slab does (each rank's
    float32 vector times its valid count, the two summed, divided by the
    summed count), one Adam step each.  Returns (params, state)."""
    from yolov4tpu_torch import train, weights
    from yolov4tpu_torch.data.pipeline import DataGenerator

    cfg = dp_config(num_devices=2, batch_size=4)
    gen = DataGenerator(lines[:15], str(CLASSES), str(folder), config=cfg,
                        seed=0)
    p0, s0 = weights.load_darknet_weights(str(wpath), 80)

    def place(t):
        return torch.as_tensor(t).to(device, torch.float32, copy=True)

    params, state = train.tree_map(place, p0), train.tree_map(place, s0)
    opt = train.make_optimizer(cfg, train.leaves(params))
    core = train._make_grad_and_metrics(80, cfg)
    for i in range(len(gen)):
        batch = train.tree_map(torch.as_tensor, gen.get_batch(i))
        n = train._batch_size(batch)
        if n % 2:
            batch = train.pad_mask_batch(batch, n + 1)
        half = train._batch_size(batch) // 2
        flats = []
        for r in range(2):
            shard = train.tree_map(
                lambda x: x[r * half:(r + 1) * half].to(device), batch)
            trees = core(params, state, shard)
            w = (float(shard["mask"].sum()) if "mask" in shard
                 else float(half))
            flats.append(torch.cat(
                [t.reshape(-1) for p in trees for t in train.leaves(p)]
                + [torch.ones(1, device=device)]) * w)
        total = flats[0] + flats[1]
        flat = total[:-1] / torch.clamp(total[-1], min=1.0)
        offset, combined = 0, []
        for p in trees:
            parts = []
            for t in train.leaves(p):
                parts.append(flat[offset:offset + t.numel()].view(t.shape))
                offset += t.numel()
            combined.append(train.unflatten(p, parts))
        grads, state, _ = combined
        opt.step(train.leaves(grads))
    gen.close()
    return params, state


def gloo_phase(torch, wpath, folder, lines, card, per_step):
    """Phase 9b: two gloo ranks sharing the card, each a worker process
    (``dp_worker``), then their checks and rank 0's checkpoint against
    ``dp_emulation``.  Returns the workers' wgrad and suppress_rank
    launches and times."""
    import shutil

    from yolov4tpu_torch import checkpoint as ckpt
    from yolov4tpu_torch import train

    work = SCRATCH / "dp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dp-worker", str(r),
         str(work)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=400)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"data-parallel rank {r} failed "
              f"(exit {p.returncode}):\n{text[-4000:]}")
    workers_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    check((work / "ck_r0_0.npz").exists()
          and not (work / "ck_r1_0.npz").exists(),
          f"checkpoint files {sorted(p.name for p in work.glob('ck_*'))}: "
          "rank 0 alone must write")
    for rk in ranks:
        r = rk["rank"]
        check(rk["info"]["backend"] == "gloo"
              and rk["info"]["num_processes"] == 2, f"rank {r}: {rk['info']}")
        check(len(rk["steps"]) == 2, f"rank {r} ran {len(rk['steps'])} "
              "steps, not 2 (b8, then the ragged 7)")
        for s in rk["steps"]:
            check(s["wgrad"] == per_step and s["tc"] == s["wgrad"]
                  and s["slabs"] == 1, f"rank {r} step {s}: not "
                  f"{per_step} tensor-core wgrad launches and one slab")
        check(rk["masked_step"] and rk["masked_eval"], f"rank {r}: the "
              "ragged tail's masked step or the masked eval did not run")
        check(rk["predict_launches"] == 1, f"rank {r}: predict_batch "
              f"launched suppress_rank {rk['predict_launches']} times")
        check(np.isfinite(rk["history"][0]["loss"])
              and np.isfinite(rk["history"][0]["val_loss"]),
              f"rank {r}: {rk['history']}")
    check(ranks[0]["digest"] == ranks[1]["digest"],
          "the two ranks' params and BN state differ after fit")
    for rk in ranks:
        step_ms = ", ".join(f"{1e3 * s['s']:.1f}" for s in rk["steps"])
        slab_ms = ", ".join(f"{m:.1f}" for m in rk["slab_ms"])
        log(f"9b gloo rank {rk['rank']}: steps {step_ms} ms (b4 a rank; "
            f"the first pays cuDNN's set-up), slab all_reduce {slab_ms} ms "
            f"(the steps', then the eval's), wgrad "
            f"{sum(s['wgrad'] for s in rk['steps'])} launches, all on the "
            f"tensor cores; predict_batch valid {rk['valid']}; peak "
            f"{rk['peak_gib']:.1f} GiB ({card})")
    log(f"9b two gloo ranks on one card: params and BN state equal (sha256 "
        f"{ranks[0]['digest'][:16]}), loss "
        f"{ranks[0]['history'][0]['loss']:.3f}, val_loss "
        f"{ranks[0]['history'][0]['val_loss']:.3f}; rank 0 alone wrote its "
        f"checkpoint; workers {workers_s:.1f} s")

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    params, state = dp_emulation(torch, wpath, folder, lines)
    torch.backends.cudnn.deterministic = False
    got_p, got_s, _, _ = ckpt.load_npz(str(work / "ck_r0_0.npz"))
    want = train.leaves(params) + train.leaves(state)
    got = train.leaves(got_p) + train.leaves(got_s)
    check(len(got) == len(want), f"{len(got)} tensors in the checkpoint, "
          f"{len(want)} in the emulation")
    diff = first_difference(torch, [t.cuda() for t in got], want)
    if diff is None:
        log(f"9b rank 0's checkpoint == the emulation bit for bit "
            f"({len(want)} tensors)")
    else:
        worst = max(rel_rms(g, w.cpu()) for g, w in zip(got, want))
        check(worst <= 1e-6, f"rank 0's checkpoint vs the emulation: rel-RMS "
              f"{worst:.3g} (limit 1e-6), first difference {diff}")
        log(f"9b rank 0's checkpoint vs the emulation: not bit-equal (first "
            f"difference {diff}), worst leaf rel-RMS {worst:.3g} <= 1e-6")
    return {"wgrad": sum(s["wgrad"] for rk in ranks for s in rk["steps"]),
            "suppress_rank": sum(rk["predict_launches"] for rk in ranks),
            "step_ms": [[1e3 * s["s"] for s in rk["steps"]] for rk in ranks],
            "slab_ms": [rk["slab_ms"] for rk in ranks]}


def dp_phase(torch, wgrad_cuda, wpath, folder, lines, card, per_step):
    """Phase 9: data-parallel training (9a NCCL at world size 1, 9b two
    gloo ranks on one card), then this process's group destroyed."""
    import torch.distributed as dist
    t = time.perf_counter()
    wl, rates = nccl_phase(torch, wgrad_cuda, wpath, folder, lines, card,
                           per_step)
    log(f"phase 9a: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    gl = gloo_phase(torch, wpath, folder, lines, card, per_step)
    log(f"phase 9b: {time.perf_counter() - t:.1f} s")
    dist.destroy_process_group()
    return {"wgrad": wl + gl["wgrad"], "suppress_rank": gl["suppress_rank"],
            **rates, "gloo_step_ms": gl["step_ms"],
            "gloo_slab_ms": gl["slab_ms"]}


# ---------------------------------------------------------------------------
# Distributed inference and the host tools: NCCL at world size 1, two gloo
# ranks on one card, the video tool
# ---------------------------------------------------------------------------

def busy_config(**kw):
    """Phase 10's model: full depth, 416^2, COCO-80, bf16 unless ``kw``
    says otherwise."""
    from yolov4tpu_torch.config import DEFAULT_CONFIG
    kw.setdefault("compute_dtype", "bfloat16")
    return dataclasses.replace(DEFAULT_CONFIG, **kw)


def busy_model(busy, **kw):
    """A facade on phase 3's calibrated weights (``busy``, a .weights file)
    with COCO's class names underscored, as the evaluation files need."""
    from yolov4tpu_torch.api import Yolov4
    classes = SCRATCH / "coco_classes_underscored.txt"
    return Yolov4(weight_path=str(busy), class_name_path=str(classes),
                  config=busy_config(**kw))


def agree(torch, got, want, label) -> float:
    """Every image of two ``predict_batch`` outputs within 1e-3 per box and
    score (``match_detections``), with a detection in each; returns the
    largest deviation."""
    check(tuple(got[0].shape) == tuple(want[0].shape) and got[0].is_cuda,
          f"{label}: boxes {tuple(got[0].shape)} on {got[0].device}, want "
          f"{tuple(want[0].shape)}")
    check(all(bool(torch.isfinite(o.float()).all()) for o in got),
          f"{label}: non-finite outputs")
    worst = 0.0
    for i in range(got[0].shape[0]):
        worst = max(worst, match_detections(numpy_outputs(got, i),
                                            numpy_outputs(want, i), 1e-3))
    return worst


def counted_predict(torch, counter, model, imgs):
    """``model.predict_batch(imgs)`` with ``nms_cuda``'s ``counter``
    (LAUNCHES or SUPPRESS_LAUNCHES) zeroed just before and read just after:
    (outputs, launches)."""
    from yolov4tpu_torch.ops import nms_cuda
    setattr(nms_cuda, counter, 0)
    out = model.predict_batch(imgs)
    torch.cuda.synchronize()
    return out, getattr(nms_cuda, counter)


def rate_in_turns(torch, models, imgs, card, label):
    """``utils.profiling.time_fn`` img/s of each of ``models`` ({name:
    facade}), in turns (a, b, b, a)."""
    from yolov4tpu_torch.utils.profiling import time_fn
    names = list(models)
    rates = {n: [] for n in names}
    for n in names + names[::-1]:
        stats = time_fn(models[n].predict_batch, imgs, iters=10, warmup=2)
        rates[n].append(len(imgs) / stats["mean_s"])
    log(f"10{label} predict_batch b{len(imgs)} bf16 uint8, time_fn img/s in "
        f"turns: " + ", ".join(f"{n} {', '.join(f'{r:.1f}' for r in rates[n])}"
                              for n in names) + f" ({card})")
    return rates


def nccl_inference_phase(torch, busy, card):
    """Phase 10a, NCCL at world size 1 in this process: ``distribute(1)``
    against the plain facade at b8 and a ragged b5, "fast" (one
    ``suppress_rank`` launch a call) and "pallas" (one ``suppress``
    launch a call), and ``quantize`` then ``distribute`` against the
    single-device int8 facade; img/s of both in turns.  Returns the
    launches of the distributed calls."""
    from yolov4tpu_torch.parallel import init_distributed

    info = init_distributed(num_processes=1, process_id=0)
    check(info["backend"] == "nccl" and info["num_processes"] == 1,
          f"init_distributed: {info}")
    u8 = scene(4, 8)
    launches = {"LAUNCHES": 0, "SUPPRESS_LAUNCHES": 0}
    rates = None
    for impl, counter in (("fast", "LAUNCHES"),
                          ("pallas", "SUPPRESS_LAUNCHES")):
        plain = busy_model(busy, nms_impl=impl)
        meshed = busy_model(busy, nms_impl=impl)
        check(meshed.distribute(1) is meshed and meshed._mesh.size == 1
              and meshed._mesh.device.type == "cuda",
              f"distribute(1): {meshed._mesh}")
        for b in (8, 5):
            got, n = counted_predict(torch, counter, meshed, u8[:b])
            check(n == 1, f"{impl} b{b}: {counter} {n} in one distributed "
                  "predict_batch")
            launches[counter] += n
            worst = agree(torch, got, plain.predict_batch(u8[:b]),
                          f"10a {impl} b{b}")
            log(f"10a NCCL world size 1, {impl} b{b}: distributed == plain "
                f"within {worst:.3g} (limit 1e-3), valid "
                f"{got[3].tolist()}, one {counter} launch")
        if impl == "fast":
            rates = rate_in_turns(torch, {"distributed": meshed,
                                          "plain": plain}, u8, card, "a")
        del plain, meshed
    calib = scene(5, 16).astype(np.float32) / 255.0
    plain = busy_model(busy).quantize(calib_imgs=calib)
    meshed = busy_model(busy).quantize(calib_imgs=calib).distribute(1)
    check(any("wq" in p for p in meshed._folded["convs"]),
          "quantize then distribute: the folded convs are not int8")
    same = all(np.array_equal(plain._act_scales[k], meshed._act_scales[k])
               for k in plain._act_scales)
    log(f"10a two calibrations on the same images: scales "
        f"{'bit-equal' if same else 'differ'}")
    for b in (8, 5):
        got, n = counted_predict(torch, "LAUNCHES", meshed, u8[:b])
        check(n == 1, f"int8 b{b}: LAUNCHES {n}")
        launches["LAUNCHES"] += n
        worst = agree(torch, got, plain.predict_batch(u8[:b]),
                      f"10a int8 b{b}")
        log(f"10a quantize then distribute(1), int8 b{b}: == the "
            f"single-device int8 facade within {worst:.3g} (limit 1e-3), "
            f"valid {got[3].tolist()}")
    del plain, meshed
    torch.cuda.empty_cache()
    return launches, rates


def read_predictions(path: pathlib.Path, names, height: int, width: int):
    """One ``export_prediction`` file as (boxes normalised by the image's
    size, scores, class indices, count): ``match_detections``'s input."""
    rows = [r.split() for r in path.read_text().splitlines()]
    if not rows:
        return np.zeros((0, 4)), np.zeros(0), np.zeros(0), 0
    vals = np.array([[float(v) for v in r[1:]] for r in rows])
    boxes = vals[:, 1:] / np.array([width, height, width, height])
    classes = np.array([names.index(r[0]) for r in rows], np.float64)
    return boxes, vals[:, 0], classes, len(rows)


DIST_BATCHES = (8, 5, 1)
DIST_DTYPES = ("float32", "bfloat16")


def row_blocks(b: int, ranks: int):
    """(start, stop, padded rows) of each rank's rows of a batch of b, as
    ``predict_batch`` splits it on a mesh."""
    rows = -(-b // ranks)
    return [(min(r * rows, b), min((r + 1) * rows, b), rows)
            for r in range(ranks)]


def dist_worker(rank: int, work: pathlib.Path) -> int:
    """One rank of phase 10b (``python3 chip_smoke.py --dist-worker RANK
    DIR``): joins a gloo group of two ranks on the card through a FileStore
    in DIR and, for float32 (TF32 off) and bf16, builds the facade on
    phase 3's weights (rank 1 adds 0.25 to every parameter first),
    ``distribute(2)``, and runs ``predict_batch`` on the first 8, 5 and 1
    images of one scene batch; then ``export_prediction`` (float32, b8)
    over DIR/anno.txt into DIR/pred_r<RANK> and ``time_fn`` of the bf16
    ``predict_batch`` at b8.  Writes DIR/out<RANK>.npz (the outputs) and
    DIR/rank<RANK>.json: the ``suppress_rank`` launches and ``all_gather``
    calls of each call, the ms of the timed b8 calls' ``gather_rows``
    (host clock, the card drained before and after) and the bytes each
    rank sends in it, the files of rank 0 seen when the export returned,
    and img/s."""
    import torch
    import torch.distributed as dist

    from yolov4tpu_torch import api, train
    from yolov4tpu_torch.ops import nms_cuda
    from yolov4tpu_torch.parallel import init_distributed
    from yolov4tpu_torch.utils.profiling import time_fn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = init_distributed(f"file://{work / 'store'}", 2, rank,
                            backend="gloo")
    gathers = []
    real_gather = api.gather_rows

    def timed_gather(tensors, mesh):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_gather(tensors, mesh)
        torch.cuda.synchronize()
        gathers.append(1e3 * (time.perf_counter() - t0))
        return out

    api.gather_rows = timed_gather
    u8 = scene(4, 8)
    outs, launches, calls, models = {}, {}, {}, {}
    for dtype in DIST_DTYPES:
        model = busy_model(SCRATCH / "busy80.weights", compute_dtype=dtype)
        if rank:
            model.sync_params(train.tree_map(lambda t: t + 0.25,
                                             model.params), model.state)
        models[dtype] = model.distribute(2)
        for b in DIST_BATCHES:
            key = f"{dtype}/b{b}"
            before = len(gathers)
            out, launches[key] = counted_predict(torch, "LAUNCHES", model,
                                                 u8[:b])
            calls[key] = len(gathers) - before
            for i, o in enumerate(out):
                outs[f"{key}/{i}"] = o.float().cpu().numpy()
    nms_cuda.LAUNCHES = 0
    before = len(gathers)
    models["float32"].export_prediction(
        str(work / "anno.txt"), str(work / f"pred_r{rank}"),
        str(SCRATCH / "train"), bs=8, verbose=False)
    torch.cuda.synchronize()
    export = {"launches": nms_cuda.LAUNCHES,
              "gathers": len(gathers) - before,
              "rank0_files": sorted(p.name for p in
                                    (work / "pred_r0").glob("*.txt"))}
    iters = 10
    stats = time_fn(models["bfloat16"].predict_batch, u8, iters=iters,
                    warmup=2)
    np.savez(work / f"out{rank}.npz", **outs)
    (work / f"rank{rank}.json").write_text(json.dumps({
        "rank": rank, "info": info, "launches": launches, "calls": calls,
        "export": export, "gather_ms": gathers[-iters:],
        "gather_bytes": sum(o.nbytes for k, o in outs.items()
                            if k.startswith("bfloat16/b8/")) // 2,
        "img_s": len(u8) / stats["mean_s"]}))
    dist.destroy_process_group()
    return 0


def pairs_within(a, b, tol: float) -> bool:
    """Whether ``match_detections`` pairs one image's detections within
    ``tol`` (a measurement, not a check)."""
    try:
        match_detections(a, b, tol)
    except SmokeFailure:
        return False
    return True


def gloo_inference_phase(torch, busy, folder, lines, card):
    """Phase 10b: two gloo ranks sharing the card, each a worker process
    (``dist_worker``).  float32 (TF32 off): every rank's outputs within
    1e-3 per box of this process's single-device facade on the whole
    batch, rank 0 alone writing the prediction files, which agree with the
    single-device facade's.  bf16: every rank's outputs within 1e-3 of the
    single-device facade on the same rows (each rank's padded block); a
    bf16 forward of 4 rows rounds differently from one of 8 (other cuDNN
    kernels), so the whole batch's bf16 result is only reported against.
    Returns the workers' ``suppress_rank`` launches and timings."""
    import shutil

    import cv2

    work = SCRATCH / "dist"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    (work / "anno.txt").write_text("\n".join(lines[:8]) + "\n")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker",
         str(r), str(work)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, text) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"distributed-inference rank {r} failed "
              f"(exit {p.returncode}):\n{text[-4000:]}")
    workers_s = time.perf_counter() - t0
    ranks = [json.loads((work / f"rank{r}.json").read_text())
             for r in range(2)]
    outs = []
    for r in range(2):
        with np.load(work / f"out{r}.npz") as f:
            outs.append(dict(f))

    u8 = scene(4, 8)
    worst = {d: 0.0 for d in DIST_DTYPES}
    # bf16 images within 1e-3 of the whole-batch call, and images compared.
    bf16_whole = [0, 0]
    for dtype in DIST_DTYPES:
        plain = busy_model(busy, compute_dtype=dtype)
        for b in DIST_BATCHES:
            if dtype == "float32":
                want = plain.predict_batch(u8[:b])
            else:
                blocks = []
                for start, stop, rows in row_blocks(b, 2):
                    x = np.zeros((rows, *u8.shape[1:]), u8.dtype)
                    x[:stop - start] = u8[start:stop]
                    blocks.append(plain.predict_batch(x))
                want = [torch.cat([blk[i] for blk in blocks])[:b]
                        for i in range(4)]
                whole = plain.predict_batch(u8[:b])
            for rk, out in zip(ranks, outs):
                key = f"{dtype}/b{b}"
                check(rk["launches"][key] == 1 and rk["calls"][key] == 1,
                      f"rank {rk['rank']} {key}: {rk['launches'][key]} "
                      f"suppress_rank launches, {rk['calls'][key]} "
                      "all_gathers (one each)")
                got = [torch.from_numpy(out[f"{key}/{i}"]).cuda()
                       for i in range(4)]
                worst[dtype] = max(worst[dtype], agree(
                    torch, got, want, f"10b rank {rk['rank']} {key}"))
                if dtype == "bfloat16":
                    for i in range(b):
                        bf16_whole[0] += pairs_within(
                            numpy_outputs(got, i), numpy_outputs(whole, i),
                            1e-3)
                        bf16_whole[1] += 1
        if dtype == "float32":
            plain.export_prediction(str(work / "anno.txt"),
                                    str(work / "pred_single"), str(folder),
                                    bs=8, verbose=False)
            names = plain.class_names
        del plain
    for rk in ranks:
        check(rk["info"]["backend"] == "gloo"
              and rk["info"]["num_processes"] == 2, f"rank {rk['rank']}: "
              f"{rk['info']}")
        check(rk["export"]["launches"] == 1 and rk["export"]["gathers"] == 1,
              f"rank {rk['rank']}: export_prediction of 8 images at b8: "
              f"{rk['export']}")
    check(not (work / "pred_r1").exists(), "rank 1 wrote prediction files")
    files = [f"train{i}.txt" for i in range(8)]
    for rk in ranks:
        check(rk["export"]["rank0_files"] == files, f"rank {rk['rank']} saw "
              f"{rk['export']['rank0_files']} when export_prediction returned")
    file_worst = 0.0
    for name in files:
        h, w = cv2.imread(str(folder / name.replace(".txt", ".jpg"))).shape[:2]
        got, want = (read_predictions(work / d / name, names, h, w)
                     for d in ("pred_r0", "pred_single"))
        check(got[3] > 0, f"{name}: no detections")
        file_worst = max(file_worst, match_detections(got, want, 1e-3))
    gather_ms = sorted(m for rk in ranks for m in rk["gather_ms"])
    log(f"10b two gloo ranks on one card (rank 1's params offset before "
        f"distribute): b8, b5, b1 on every rank, float32 within "
        f"{worst['float32']:.3g} of the single-device facade, bf16 within "
        f"{worst['bfloat16']:.3g} of it on the same row blocks (limit "
        f"1e-3); one suppress_rank launch and one all_gather a call; bf16 "
        f"against the single-device call on the whole batch: "
        f"{bf16_whole[0]} of {bf16_whole[1]} images within 1e-3; "
        f"workers {workers_s:.1f} s ({card})")
    log(f"10b export_prediction (float32, b8) of 8 JPEGs: rank 0 alone "
        f"wrote, both ranks saw its 8 files on return, within "
        f"{file_worst:.3g} of the single-device facade's files")
    log(f"10b gather_rows (one all_gather over gloo, "
        f"{ranks[0]['gather_bytes']} bytes a rank) in the timed b8 calls: "
        f"{len(gather_ms)} calls on the two ranks, median "
        f"{statistics.median(gather_ms):.3f} ms, range {gather_ms[0]:.3f}-"
        f"{gather_ms[-1]:.3f} ms (host clock, card drained; {card})")
    rates = ", ".join(f"{rk['img_s']:.1f}" for rk in ranks)
    log(f"10b time_fn predict_batch b8 bf16 uint8 over two gloo ranks: "
        f"{rates} img/s (ranks 0, 1; {card})")
    torch.cuda.empty_cache()
    return {"suppress_rank": sum(sum(rk["launches"].values())
                                 + rk["export"]["launches"] for rk in ranks),
            "gather_ms": gather_ms,
            "img_s": [rk["img_s"] for rk in ranks]}


def video_phase(torch, busy, card, frames: int = 40, size=(640, 360)):
    """Phase 10c: a synthetic mp4v clip of ``frames`` scene frames at
    ``size`` annotated through the video tool's command line (416^2, b8,
    bf16, phase 3's weights), its frames read back and counted, one
    ``suppress_rank`` launch a batch; frames/s of ``annotate_video``.
    Returns its launches and rate."""
    import cv2

    from yolov4tpu_torch.ops import nms_cuda
    from yolov4tpu_torch.tools import video

    clip, out = SCRATCH / "clip.mp4", SCRATCH / "clip_annotated.mp4"
    writer = cv2.VideoWriter(str(clip), cv2.VideoWriter_fourcc(*"mp4v"),
                             25.0, size)
    check(writer.isOpened(), f"cv2 {cv2.__version__} cannot write mp4v")
    for i in range(frames):
        writer.write(cv2.resize(scene(40 + i, 1)[0], size))
    writer.release()
    seconds = []
    real = video.annotate_video

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        n = real(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return n

    video.annotate_video = timed
    nms_cuda.LAUNCHES = 0
    try:
        n = video.main(["--weights", str(busy), "--classes",
                        str(SCRATCH / "coco_classes_underscored.txt"),
                        "--input", str(clip), "--output", str(out),
                        "--bs", "8"])
    finally:
        video.annotate_video = real
    torch.cuda.synchronize()
    launches = nms_cuda.LAUNCHES
    cap = cv2.VideoCapture(str(out))
    check(cap.isOpened(), f"cannot read {out.name} back")
    fourcc = int(cap.get(cv2.CAP_PROP_FOURCC))
    codec = "".join(chr((fourcc >> 8 * i) & 0xFF) for i in range(4))
    read = 0
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        check(frame.shape[:2] == (size[1], size[0]),
              f"frame {read} is {frame.shape}")
        read += 1
    cap.release()
    batches = -(-frames // 8)
    check(n == frames and read == frames, f"annotate_video returned {n}, "
          f"{read} frames read back, {frames} written")
    check(launches == batches, f"suppress_rank launched {launches} times "
          f"for {batches} batches")
    rate = frames / seconds[0]
    log(f"10c video CLI: {frames} frames {size[0]}x{size[1]} annotated at "
        f"416^2 b8 bf16, written with mp4v, {read} read back (FOURCC "
        f"{codec!r}, cv2 {cv2.__version__}), {launches} suppress_rank "
        f"launches; annotate_video {rate:.1f} frames/s ({card})")
    return {"suppress_rank": launches, "frames_s": rate, "codec": codec}


def distributed_phase(torch, busy, folder, lines, card):
    """Phase 10: distributed inference (10a NCCL at world size 1, 10b two
    gloo ranks on one card) and the video tool (10c); this process's group
    destroyed after 10a."""
    import torch.distributed as dist
    t = time.perf_counter()
    launches, rates = nccl_inference_phase(torch, busy, card)
    dist.destroy_process_group()
    log(f"phase 10a: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    gloo = gloo_inference_phase(torch, busy, folder, lines, card)
    log(f"phase 10b: {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    vid = video_phase(torch, busy, card)
    log(f"phase 10c: {time.perf_counter() - t:.1f} s")
    return {"suppress_rank": (launches["LAUNCHES"] + gloo["suppress_rank"]
                              + vid["suppress_rank"]),
            "suppress": launches["SUPPRESS_LAUNCHES"], "rates": rates,
            "gather_ms": gloo["gather_ms"], "frames_s": vid["frames_s"]}


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
    from yolov4tpu_torch.ops import build, nms_cuda, wgrad_cuda

    # Every float32 comparison below runs in full float32: cuDNN would
    # otherwise run float32 convolutions in TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    start = time.perf_counter()
    phase_start = [start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"phase {name}: {now - phase_start[0]:.1f} s")
        phase_start[0] = now

    # --- 1. card and build ---------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    sources = ("suppress_rank", "suppress", "wgrad_3x3")
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        sos = list(pool.map(build.build, sources))   # one nvcc each
    log(f"built {', '.join(so.name for so in sos)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for so in sos:
        for line in build.ptxas_report(so):
            log(f"  ptxas {so.name.split('-')[0]}: {line}")

    phase_done("1 (card and build)")

    # --- 2. kernels vs plain versions --------------------------------------
    worst = kernel_phase(torch, nms_cuda)
    sorted_worst = sorted_kernel_phase(torch, nms_cuda)
    phase_done("2 (NMS kernels vs plain)")

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
    k8 = time_stages(torch, nms_cuda, m32, u8, "b8 f32", card)
    time_stages(torch, nms_cuda, m16, u8, "b8 bf16", card)
    u64 = scene(2, 64)
    time_stages(torch, nms_cuda, m16, u64, "b64 bf16", card)
    for bsz, imgs in ((8, u8), (64, u64)):
        rate = predict_rate(torch, m16, imgs)
        log(f"predict_batch bf16 b{bsz} uint8: {rate:.1f} img/s ({card})")

    phase_done("3 (inference, 'fast')")

    # --- 3b. nms_impl="pallas" -------------------------------------------
    pallas = {}
    for name, base in (("f32", DEFAULT_CONFIG),
                       ("bf16", dataclasses.replace(
                           DEFAULT_CONFIG, compute_dtype="bfloat16"))):
        pallas[name] = Yolov4(weight_path=str(wpath),
                              class_name_path=str(CLASSES),
                              config=dataclasses.replace(base,
                                                         nms_impl="pallas"))
        pallas[name].sync_params(params, pallas[name].state)
    cpu.config = dataclasses.replace(cpu.config, nms_impl="pallas")
    cpu.sync_params(params, cpu.state)
    _, err, s8 = pallas_phase(
        torch, nms_cuda, m32, m16, pallas["f32"], pallas["bf16"], cpu, f32,
        u8, u64, card)
    sorted_worst = max(sorted_worst, err)
    del pallas, cpu, m16, outs
    torch.cuda.empty_cache()

    phase_done("3b (inference, 'pallas')")

    # --- 3c. the evaluation path -----------------------------------------
    folder = SCRATCH / "train"
    lines = write_train_set(folder)
    eval_launches = eval_phase(torch, nms_cuda, wpath, params, folder, card)
    torch.cuda.empty_cache()
    phase_done("3c (evaluation)")

    # --- 4. the weight-gradient kernel ----------------------------------
    shapes = wgrad_shapes()
    check(sum(shapes.values()) == 37 and len(shapes) == 9,
          f"expected 37 3x3 stride-1 convs in 9 shapes, got {dict(shapes)}")
    wgrad_err = wgrad_phase(torch, wgrad_cuda, shapes)
    wg = wgrad_times(torch, wgrad_cuda, shapes, card)
    phase_done("4 (wgrad kernel)")

    # --- 5. the training path --------------------------------------------
    wlaunches, params0, state0 = train_phase(torch, wgrad_cuda, wpath,
                                             folder, lines, card, shapes)
    fidelity_phase(torch, params0, state0, folder, lines, card)
    rate_phase(torch, params0, state0, folder, lines, card)
    del params0, state0
    torch.cuda.empty_cache()
    phase_done("5 (training)")

    # --- 6. persistence --------------------------------------------------
    persisted = persistence_phase(torch, nms_cuda, wgrad_cuda, wpath, folder,
                                  lines, card, sum(shapes.values()))
    phase_done("6 (persistence)")

    # --- 7. int8 and serving ---------------------------------------------
    torch.cuda.empty_cache()
    models = int8_phase(torch, nms_cuda, wpath, card)
    served = serving_phase(torch, nms_cuda, models, card)
    int8_launches = models["launches"]
    del models
    torch.cuda.empty_cache()
    phase_done("7 (int8 and serving)")

    # --- 8. augmented ingest and multi-scale training ---------------------
    ingested = ingest_phase(torch, wgrad_cuda, nms_cuda, wpath, card)
    phase_done("8 (augmented ingest and multi-scale training)")

    # --- 9. data-parallel training -----------------------------------------
    torch.cuda.empty_cache()
    parallel = dp_phase(torch, wgrad_cuda, wpath, folder, lines, card,
                        sum(shapes.values()))
    phase_done("9 (data-parallel training)")

    # --- 10. distributed inference and the video tool ---------------------
    busy = SCRATCH / "busy80.weights"
    weights.save_darknet_weights(params, m32.state, str(busy))
    del m32
    torch.cuda.empty_cache()
    served10 = distributed_phase(torch, busy, folder, lines, card)
    phase_done("10 (distributed inference and video)")
    log(f"all phases: {time.perf_counter() - start:.1f} s")

    kernels = [{"name": "suppress_rank", "route": "cuda",
                "source": "yolov4tpu_torch/csrc/suppress_rank.cu",
                "replaces": "yolov4tpu/ops/nms_pallas.py:191",
                "launches": (launches + persisted["suppress_rank"]
                             + int8_launches + served["suppress_rank"]
                             + ingested["suppress_rank"]
                             + parallel["suppress_rank"]
                             + served10["suppress_rank"]),
                "max_abs_err": worst,
                "ms": k8["ms"], "device_ms": k8["device_ms"],
                "plain_ms": k8["plain_ms"],
                "bound_ms": k8["bound_ms"], "bound_by": k8["bound_by"],
                "library_ms": None},
               {"name": "suppress", "route": "cuda",
                "source": "yolov4tpu_torch/csrc/suppress.cu",
                "replaces": "yolov4tpu/ops/nms_pallas.py:37",
                "launches": (eval_launches + persisted["suppress"]
                             + served["suppress"] + served10["suppress"]),
                "max_abs_err": sorted_worst,
                "ms": s8["ms"], "device_ms": s8["device_ms"],
                "plain_ms": s8["plain_ms"],
                "bound_ms": s8["bound_ms"], "bound_by": s8["bound_by"],
                "library_ms": None},
               {"name": "wgrad_3x3", "route": "cuda",
                "source": "yolov4tpu_torch/csrc/wgrad_3x3.cu",
                "replaces": "yolov4tpu/ops/wgrad_pallas.py:48",
                "launches": (wlaunches + persisted["wgrad"]
                             + ingested["wgrad"] + parallel["wgrad"]),
                "max_abs_err": max(wgrad_err, ingested["wgrad_err"]),
                "ms": wg["ms"], "plain_ms": wg["plain_ms"],
                "bound_ms": wg["bound_ms"], "bound_by": wg["bound_by"],
                "library_ms": wg["library_ms"],
                # ms and library_ms are device times (graph_ms); these are
                # eager launches, host launch cost included, as earlier
                # slices timed them.
                "eager_ms": wg["eager_ms"],
                "library_eager_ms": wg["library_eager_ms"],
                # Device times per b8 bf16 step at the multi-scale range's
                # ends (phase 8f); the keys above are at 416^2.
                "per_step_by_side": ingested["wgrad_by_size"]}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        sys.exit(dp_worker(int(sys.argv[2]), pathlib.Path(sys.argv[3])))
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), pathlib.Path(sys.argv[3])))
    sys.exit(main())
