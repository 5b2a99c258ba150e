"""Data-parallel training over the cards of one host: ``init_distributed``
over NCCL, one process a card, each running ``prefetch`` over its own
``DataGenerator`` into ``Trainer.train_step`` on a mesh of every rank
(``parallel.mesh``), whose step ends in one all-reduce of one slab.

The harness's process is rank 0: its trace and spans are the run's.  It
starts the other ranks as processes of this file (``main``), writes the
JPEGs, joins the process group, and decides for every rank when the window
ends: after each step it broadcasts, over a gloo group of the same ranks,
whether another follows.  Each call records the step's global images.

The traffic file gives ``ranks``, ``batch`` (images a rank a step),
``images`` (JPEGs written from the seed into TMPDIR, each ``image_hw`` in
size, with ``boxes`` = [least, most] boxes of at least ``min_box``
pixels, classes uniform; rank r takes the r-th quarter), ``jpeg_quality``,
``checked_steps`` (the first steps, run in set-up and compared with the
reference), ``trace_steps`` and ``pallas_wgrad``.  Rank r's generator is
seeded from the run's seed and r, so the reference replays its draws
(``loops/train.py``'s ``reference_batches``) and each step's batch as the
ranks' blocks (``reference.train_dp``): BN statistics a block, gradients
weighed by the blocks' image counts, float32 Adam.

Readings for the limits of ``correct`` (``perfbench/readings.py``; the
benchmark's own runs take none): ``"control"``, the reference with every
tensor of its layers rounded to float8 (``reference.lowp``: e4m3,
gradients e5m2), judged in the program's place.
"""

from __future__ import annotations

import argparse
import contextlib
import datetime
import gc
import os
import socket
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve()
sys.path.insert(0, str(HERE.parents[2]))

from perfbench.harness import env, manifest, weights  # noqa: E402
from perfbench.harness.runner import Run  # noqa: E402
from perfbench.harness.trace import DeviceTrace, Spans, now_ns  # noqa: E402
from perfbench.reference import judge_train, lowp  # noqa: E402
from perfbench.reference import train as ref_train  # noqa: E402
from perfbench.reference import train_dp as ref_dp  # noqa: E402

BETA1 = 0.9  # the program's Adam, whose first moment gives its gradient
TIMEOUT_S = 300  # a rank that never arrives fails the run


def log(*parts):
    print(*parts, flush=True)


def _single():
    return manifest.load_module(HERE.with_name("train.py"), "loop_train")


def rank_seed(seed: int, rank: int) -> int:
    return env.sub_seed(seed, 100 + rank)


def rank_lines(lines, rank: int, ranks: int):
    q = len(lines) // ranks
    return lines[rank * q:(rank + 1) * q]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(cell, seed: int, seconds: float, trace: bool, device,
        variants=()) -> Run:
    if set(variants) - {"control"}:
        raise ValueError(f"train_dp takes the variant 'control' only, not "
                         f"{variants}")
    tr = cell.traffic
    ranks = tr["ranks"]
    folder = env.tmpdir(cell.name)
    port = _free_port()
    logs = [open(folder / f"rank{r}.log", "w") for r in range(1, ranks)]
    paths = {**os.environ, "PYTHONPATH": os.pathsep.join(p for p in sys.path
                                                        if p)}
    procs = [subprocess.Popen(
        [sys.executable, str(HERE), "--root", str(cell.root),
         "--workload", cell.name, "--seed", str(seed), "--rank", str(r),
         "--port", str(port), "--device", str(device)],
        stdout=f, stderr=subprocess.STDOUT, env=paths) for r, f in
        zip(range(1, ranks), logs)]
    try:
        log(env.card_line(device))
        lines = _single().write_images(folder, seed, tr,
                                       cell.config["num_classes"], device)
        for r, p in enumerate(procs, 1):
            if p.poll() is not None:
                raise RuntimeError(f"rank {r} exited with {p.returncode}")
        out = train_rank(cell, seed, 0, port, seconds, trace, device, lines)
        for r, p in enumerate(procs, 1):
            if p.wait(timeout=TIMEOUT_S) != 0:
                raise RuntimeError(f"rank {r} exited with {p.returncode}")
    except BaseException:
        for r, (p, f) in enumerate(zip(procs, logs), 1):
            if p.poll() is None:
                p.kill()
            f.flush()
            tail = (folder / f"rank{r}.log").read_text()[-4000:]
            print(f"rank {r} log:\n{tail}", file=sys.stderr)
        raise
    finally:
        for f in logs:
            f.close()
    calls, window, peak, dt, spans, losses, grad, after = out
    checks, looks = check(cell, seed, lines, folder, losses, grad, after,
                          device, "control" in variants)
    info = dict(env.device_info(device, peak), count=ranks)
    return Run(calls=calls, window=window, first_call=window[0],
               checks=checks, attempted=sum(c["images"] for c in calls),
               failed=0, memory_peak=peak, device=info, trace=dt,
               spans=spans, extra={"variants": looks})


def train_rank(cell, seed, rank, port, seconds, trace, device, lines):
    """One rank's part: set-up, the checked steps, the window.  Rank 0
    returns (calls, window, peak memory, DeviceTrace, Spans, losses, first
    gradient, parameters after the checked steps); the others None."""
    import torch.distributed as dist

    from yolov4tpu_torch.config import YoloConfig
    from yolov4tpu_torch.data import pipeline
    from yolov4tpu_torch.device import to_device_async
    from yolov4tpu_torch.parallel.mesh import init_distributed, make_mesh
    from yolov4tpu_torch.train import Trainer, _Shard, leaves, tree_map

    cfg, tr = cell.config, cell.traffic
    side, ncls, b, ranks = (cfg["img_size"], cfg["num_classes"], tr["batch"],
                            tr["ranks"])
    depth = tuple(cfg["csp_repeats"])
    cuda = str(device) != "cpu"
    torch.set_num_threads(1)
    init_distributed(f"localhost:{port}", ranks, rank,
                     backend="nccl" if cuda else "gloo", timeout=TIMEOUT_S)
    dev = (torch.device("cuda", torch.cuda.current_device()) if cuda
           else torch.device("cpu"))
    control = dist.new_group(backend="gloo",
                             timeout=datetime.timedelta(seconds=TIMEOUT_S))
    folder = env.tmpdir(cell.name)
    classes = env.write_classes(folder / f"classes{rank}.txt", ncls)
    params, state = weights.make(env.sub_seed(seed, 0), side, ncls, dev,
                                 depth)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    conf = YoloConfig(img_size=(side, side, 3), csp_repeats=depth,
                      batch_size=b, num_devices=ranks,
                      compute_dtype=cfg["compute_dtype"],
                      pallas_wgrad=tr["pallas_wgrad"],
                      max_boxes=cfg["max_boxes"],
                      iou_loss_thresh=cfg["iou_loss_thresh"])
    trainer = Trainer(conf, ncls, params, state, mesh=make_mesh(ranks, dev),
                      device=dev)
    del params, state
    if rank == 0:
        (folder / "lines.txt").write_text("\n".join(lines) + "\n")
    dist.barrier(group=control)   # rank 0 has written the JPEGs
    if rank != 0:
        lines = (folder / "lines.txt").read_text().splitlines()
    gen = pipeline.DataGenerator(
        rank_lines(lines, rank, ranks), str(classes), str(folder),
        max_boxes=cfg["max_boxes"], shuffle=True,
        config=conf.replace(num_devices=1),
        seed=env.sub_seed(rank_seed(seed, rank), 4))

    def place(batch):
        # The producer thread: this rank's batch is its shard of the step.
        with torch.cuda.device(dev) if cuda else contextlib.nullcontext():
            return _Shard(tree_map(lambda x: to_device_async(x, dev), batch))

    feed = pipeline.prefetch(gen, transform=place)
    losses, grad = [], None
    opt = trainer.optimizer
    for step in range(tr["checked_steps"]):
        metrics = trainer.train_step(next(feed))
        if rank == 0:
            losses.append(float(metrics["loss"]))
            if step == 0:
                grad = [opt.opt.state[t]["exp_avg"].detach().cpu()
                        / (1 - BETA1) for t in opt.tensors]
    after = ([t.detach().cpu().clone() for t in leaves(trainer.params)]
             if rank == 0 else None)

    flag = torch.ones(1, dtype=torch.int32)
    spans, dt = Spans(), None
    if rank == 0 and trace:
        dt = DeviceTrace(device)
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
        if rank == 0:
            spans.add("next_batch", t0, t1, len(calls))
            spans.add("train_step", t1, t2, len(calls))
            calls.append({"start": t0, "end": t2, "images": b * ranks})
            done = (t2 - start >= seconds * 1e9
                    or (limit and len(calls) >= limit))
            flag[0] = 0 if done else 1
        dist.broadcast(flag, 0, group=control)
        if not flag[0]:
            break
    if cuda:
        torch.cuda.synchronize()
    end = now_ns()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    if dt is not None:
        dt.stop()
    feed.close()
    gen.close()
    del trainer, batch, opt
    dist.barrier(group=control)
    dist.destroy_process_group()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    if rank != 0:
        return None
    spans.add("drain", calls[-1]["end"], end, len(calls) - 1)
    calls[-1]["end"] = end
    log(f"window: {len(calls)} steps of {ranks} x {b} images")
    return calls, (start, end), peak, dt, spans, losses, grad, after


def check(cell, seed, lines, folder, losses, grad, after, device,
          control=False):
    """Rank 0's first steps (the all-reduced gradient its optimizer
    received, the parameters after them) against the reference's replay
    of every rank's batches as blocks of one step; with ``control``, the
    float8 reference's too.  Returns (the program's numbers, {"control":
    its numbers} or {})."""
    cfg, tr = cell.config, cell.traffic
    side, ncls, ranks = cfg["img_size"], cfg["num_classes"], tr["ranks"]
    depth = tuple(cfg["csp_repeats"])
    steps = len(losses)
    single = _single()
    per_rank = [single.reference_batches(cell, rank_seed(seed, r),
                                         rank_lines(lines, r, ranks), folder,
                                         steps) for r in range(ranks)]
    blocks = [[per_rank[r][s] for r in range(ranks)] for s in range(steps)]
    params, _ = weights.make(env.sub_seed(seed, 0), side, ncls, device,
                             depth)
    start = [t.detach().cpu().clone() for t in ref_train.leaves(params)]
    ref_losses, ref_grad, ref_last = ref_dp.run_steps(
        params, blocks, ncls, steps, device=device, depth=depth)
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

    looks = {}
    if control:
        looks["control"] = numbers("control", *ref_dp.run_steps(
            params, blocks, ncls, steps, quant=lowp.fp8_e4m3, device=device,
            depth=depth))
    return numbers("program", losses, grad, after), looks


def main(argv=None) -> int:
    """A rank other than 0, started by ``run``."""
    p = argparse.ArgumentParser(description="one rank of train_dp")
    for name in ("--root", "--workload", "--device"):
        p.add_argument(name, required=True)
    for name in ("--seed", "--rank", "--port"):
        p.add_argument(name, type=int, required=True)
    args = p.parse_args(argv)
    env.prepare()
    cell = manifest.cell(args.workload, Path(args.root))
    train_rank(cell, args.seed, args.rank, args.port, 0.0, False,
               args.device, None)
    return 0


if __name__ == "__main__":
    sys.exit(main())
