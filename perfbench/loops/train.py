"""Training: the inner loop of ``Trainer.fit`` on its own, ``prefetch``
over a ``DataGenerator`` (its default route) feeding
``Trainer.train_step``, from weights made from the seed.

The traffic file gives ``batch``, ``images`` (JPEGs written from the seed
into TMPDIR, each ``image_hw`` in size, with ``boxes`` = [least, most]
boxes of at least ``min_box`` pixels, classes uniform), ``jpeg_quality``,
``checked_steps`` (the first steps, run in set-up through the window's own
call and feed and compared with the reference), ``trace_steps`` (steps a
traced window holds at most) and ``pallas_wgrad``.

Readings for the limits of ``correct`` (``perfbench/readings.py``; the
benchmark's own runs take none), each judged beside the program, in its
place, against the same float32 reference: ``"control"``, the reference
with every tensor of its layers rounded to float8 (``reference.lowp``:
e4m3, gradients e5m2); ``"half_batch"``, the reference on the first half
of each batch, the fault of a step that leaves half of its batch out;
and three looks at what rounding alone moves: ``"bf16"``, the reference
rounded to bfloat16 where a bfloat16 network holds its tensors,
gradients passed straight through; ``"bf16_grad"``, the same with each
gradient there rounded to bfloat16 as well; ``"bf16_affine"``, the same
again with BatchNorm applied as y * scale + shift in bfloat16, the form
the program computes it in.  ``"cudnn_wgrad"`` is a witness of another
kind: the program itself with its weight-gradient kernel switched off
(cuDNN's in its place), judged in the program's place.
"""

from __future__ import annotations

import gc

import numpy as np
import torch

from perfbench.harness import env, weights
from perfbench.harness.runner import Run
from perfbench.harness.scene import scene
from perfbench.harness.trace import DeviceTrace, Spans, now_ns
from perfbench.reference import encode, ingest, judge_train, lowp
from perfbench.reference import train as ref_train

BETA1 = 0.9  # the program's Adam, whose first moment gives its gradient


def log(*parts):
    print(*parts, flush=True)


def write_images(folder, seed: int, tr: dict, num_classes: int, device):
    """The JPEGs and their annotation lines ("name x1,y1,x2,y2,c ...")."""
    import cv2
    h, w = tr["image_hw"]
    imgs = scene(env.sub_seed(seed, 5), tr["images"], h, w, device)
    rng = np.random.default_rng(env.sub_seed(seed, 6))
    lo, hi = tr["boxes"]
    m = tr["min_box"]
    lines = []
    for i, img in enumerate(imgs):
        name = f"img_{i:03d}.jpg"
        ok, buf = cv2.imencode(".jpg", img[:, :, ::-1],
                               [cv2.IMWRITE_JPEG_QUALITY, tr["jpeg_quality"]])
        if not ok:
            raise RuntimeError("JPEG encoding failed")
        (folder / name).write_bytes(buf.tobytes())
        boxes = []
        for _ in range(int(rng.integers(lo, hi + 1))):
            x1, y1 = int(rng.integers(0, w - m)), int(rng.integers(0, h - m))
            x2 = int(rng.integers(x1 + m, min(w, x1 + w // 2) + 1))
            y2 = int(rng.integers(y1 + m, min(h, y1 + h // 2) + 1))
            boxes.append(f"{x1},{y1},{x2},{y2},"
                         f"{int(rng.integers(0, num_classes))}")
        lines.append(" ".join([name] + boxes))
    return lines


def run(cell, seed: int, seconds: float, trace: bool, device,
        variants=()) -> Run:
    from yolov4tpu_torch import native
    from yolov4tpu_torch.config import YoloConfig
    from yolov4tpu_torch.data import pipeline
    from yolov4tpu_torch.ops import wgrad_cuda
    from yolov4tpu_torch.train import Trainer, leaves

    cfg, tr = cell.config, cell.traffic
    side, ncls = cfg["img_size"], cfg["num_classes"]
    depth, b = tuple(cfg["csp_repeats"]), tr["batch"]
    cuda = str(device) != "cpu"
    log(env.card_line(device))
    folder = env.tmpdir(cell.name)
    lines = write_images(folder, seed, tr, ncls, device)
    classes = env.write_classes(folder / "classes.txt", ncls)
    params, state = weights.make(env.sub_seed(seed, 0), side, ncls, device,
                                 depth)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    conf = YoloConfig(img_size=(side, side, 3), csp_repeats=depth,
                      batch_size=b, compute_dtype=cfg["compute_dtype"],
                      pallas_wgrad=(tr["pallas_wgrad"]
                                    and "cudnn_wgrad" not in variants),
                      max_boxes=cfg["max_boxes"],
                      iou_loss_thresh=cfg["iou_loss_thresh"])
    trainer = Trainer(conf, ncls, params, state, device=device)
    del params, state
    gen = pipeline.DataGenerator(lines, str(classes), str(folder),
                                 max_boxes=cfg["max_boxes"], shuffle=True,
                                 config=conf, seed=env.sub_seed(seed, 4))
    feed = pipeline.prefetch(gen, transform=trainer._prefetch_place)
    log(f"{len(lines)} JPEGs in TMPDIR; ingest native={gen.use_native} "
        f"({native.build_variant()})")

    losses, grad = [], None
    opt = trainer.optimizer
    for step in range(tr["checked_steps"]):
        losses.append(float(trainer.train_step(next(feed))["loss"]))
        if step == 0:
            grad = [opt.opt.state[t]["exp_avg"].detach().cpu() / (1 - BETA1)
                    for t in opt.tensors]
    after = [t.detach().cpu().clone() for t in leaves(trainer.params)]

    counters = (wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES,
                native.NATIVE_BATCHES, pipeline.PYTHON_BATCHES)
    spans, dt = Spans(), (DeviceTrace(device) if trace else None)
    if dt is not None:
        dt.start()
    limit = tr["trace_steps"] if trace else None
    calls = []
    start = now_ns()
    while True:
        t0 = now_ns()
        batch = next(feed)
        t1 = now_ns()
        trainer.train_step(batch)
        t2 = now_ns()
        spans.add("next_batch", t0, t1, len(calls))
        spans.add("train_step", t1, t2, len(calls))
        calls.append({"start": t0, "end": t2, "images": b})
        if t2 - start >= seconds * 1e9 or (limit and len(calls) >= limit):
            break
    if cuda:
        torch.cuda.synchronize()
    end = now_ns()
    spans.add("drain", calls[-1]["end"], end, len(calls) - 1)
    calls[-1]["end"] = end
    if dt is not None:
        dt.stop()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    now = (wgrad_cuda.LAUNCHES, wgrad_cuda.TC_LAUNCHES,
           native.NATIVE_BATCHES, pipeline.PYTHON_BATCHES)
    log("window: {} steps; wgrad launches {} (tensor cores {}); native "
        "batches {}, python batches {}".format(
            len(calls), *(a - c for a, c in zip(now, counters))))
    feed.close()
    gen.close()
    del trainer, batch, opt
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    checks, looks = check(cell, seed, lines, folder, losses, grad, after,
                          device, variants)
    return Run(calls=calls, window=(start, end), first_call=start,
               checks=checks, attempted=len(calls) * b, failed=0,
               memory_peak=peak, device=env.device_info(device, peak),
               trace=dt, spans=spans, extra={"variants": looks})


def reference_batches(cell, seed: int, lines, folder, steps: int):
    """The first ``steps`` batches as the generator draws them from its
    seed (its epoch shuffle, then one draw of per-sample seeds a batch,
    each permuting its image's boxes), worked out by the reference's own
    ingest and encoder."""
    cfg, tr = cell.config, cell.traffic
    side, ncls, b = cfg["img_size"], cfg["num_classes"], tr["batch"]
    m = cfg["max_boxes"]
    rng = np.random.default_rng(env.sub_seed(seed, 4))
    order = np.arange(len(lines))
    rng.shuffle(order)
    out = []
    for step in range(steps):
        seeds = rng.integers(0, 2 ** 63, size=b, dtype=np.uint64)
        imgs = np.zeros((b, side, side, 3), np.float32)
        boxes = np.zeros((b, m, 5), np.float32)
        for j, li in enumerate(order[step * b:(step + 1) * b]):
            parts = lines[li].split()
            raw = np.array([[float(v) for v in s.split(",")]
                            for s in parts[1:]], np.float32).reshape(-1, 5)
            raw = raw[np.random.default_rng(seeds[j]).permutation(
                len(raw))][:m]
            imgs[j], scaled = ingest.sample(str(folder / parts[0]), raw, side)
            boxes[j, :len(scaled)] = scaled
        labels, xywh = encode.encode(boxes, side, ncls)
        out.append((imgs, labels, xywh))
    return out


def _half(batches):
    return [tuple(x[:len(x) // 2] if not isinstance(x, list)
                  else [g[:len(g) // 2] for g in x] for x in bt)
            for bt in batches]


def variant_steps(name, params, batches, ncls, steps, device, depth):
    """(losses, first gradient, last parameters) of a variant put in the
    program's place (see the module's docstring)."""
    quant = {"control": lowp.fp8_e4m3, "bf16": lowp.bf16,
             "bf16_grad": lowp.bf16_grad,
             "bf16_affine": lowp.bf16_grad}.get(name)
    if name == "half_batch":
        batches = _half(batches)
    elif quant is None:
        raise ValueError(f"no training variant {name!r}")
    return ref_train.run_steps(params, batches, ncls, steps, quant=quant,
                               device=device, depth=depth,
                               affine=name == "bf16_affine")


def check(cell, seed, lines, folder, losses, grad, after, device,
          variants=()):
    """The program's first steps against the reference's, and each of
    ``variants`` in the program's place: (the program's numbers,
    {variant: its numbers})."""
    cfg = cell.config
    side, ncls = cfg["img_size"], cfg["num_classes"]
    depth = tuple(cfg["csp_repeats"])
    steps = len(losses)
    batches = reference_batches(cell, seed, lines, folder, steps)
    params, _ = weights.make(env.sub_seed(seed, 0), side, ncls, device,
                             depth)
    start = [t.detach().cpu().clone() for t in ref_train.leaves(params)]
    ref_losses, ref_grad, ref_last = ref_train.run_steps(
        params, batches, ncls, steps, device=device, depth=depth)
    ref_change = [a - s for a, s in zip(ref_last, start)]

    def numbers(name, losses, grad, after):
        change = [a - s for a, s in zip(after, start)]
        log(f"{name}: losses {losses} reference {ref_losses}")
        log(f"{name}: widest gradient leaves (leaf, gap, got, reference, "
            f"median): {judge_train.worst_leaves(grad, ref_grad)}")
        log(f"{name}: widest change leaves: "
            f"{judge_train.worst_leaves(change, ref_change)}")
        return judge_train.judge(losses, grad, change, ref_losses, ref_grad,
                                 ref_change)

    looks = {name: numbers(name, *variant_steps(name, params, batches, ncls,
                                                steps, device, depth))
             for name in variants if name != "cudnn_wgrad"}
    return numbers("program", losses, grad, after), looks
