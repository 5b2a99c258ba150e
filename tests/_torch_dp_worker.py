"""One rank of the port's two-process data-parallel tests (gloo, CPU).

    python _torch_dp_worker.py <rank> <world> <work dir>

Reads ``spec.json`` (the scenarios), ``params.pt`` (the starting params
and BN state, ``torch.save``d port tensors) and ``inputs.npz`` (global
batches, keys "<batch>/image", "<batch>/labels/<i>", "<batch>/boxes"[, "<batch>/mask"])
from the work directory, joins the process group through a FileStore there,
runs every scenario and writes ``out_<rank>.npz``: per scenario the final
parameters and BN state (port layout, ``leaves`` order), the metrics, and
how many ``torch.distributed.all_reduce`` and ``train._allreduce_slab``
calls each made, and its seconds.  A "fit" scenario writes its checkpoints
under ``<work dir>/<scenario name>/``.  A "rank0_eval" scenario runs
``EvalMapCallback`` over ``SlowEvaluator``, slow and then failing on rank
0, each time followed by a step, on a mesh whose steps' group has a short
collective timeout.  A "distribute" scenario shards a facade's inference
over the ranks (``Yolov4.distribute``; rank 1's params offset first) and
records its ``predict_batch`` outputs, float and int8, and how many
``all_gather`` calls each made, exports prediction files into
``<work dir>/<scenario name>/pred_r<rank>``, then runs ``fit`` with
``MetricsLogger`` and ``EvalMapCallback`` on the distributed facade.

Imports the port only (no JAX, nothing of the tests' conftest), so the
parent test's JAX state never reaches it.
"""

import contextlib
import dataclasses
import datetime
import io
import json
import pathlib
import sys
import time
import types

import numpy as np
import torch


class SGD:
    """Plain SGD, t -= lr * g: an update linear in the gradients, so a
    weighted combination of them shows in the parameters undistorted."""

    def __init__(self, tensors, lr: float):
        self.tensors = list(tensors)
        self.lr = lr

    @torch.no_grad()
    def step(self, grads):
        for t, g in zip(self.tensors, grads):
            t.sub_(self.lr * g)


class SlowEvaluator:
    """Stands in for the facade in ``EvalMapCallback``: its evaluation takes
    ``seconds`` (in ``export_gt``), then raises if ``fail``, else scores a
    mAP of 0.5."""

    def __init__(self, seconds: float, fail: bool):
        self.seconds, self.fail = seconds, fail

    def sync_from_trainer(self, trainer):
        pass

    def export_gt(self, annotation_path, out_dir):
        time.sleep(self.seconds)
        if self.fail:
            raise ValueError("the evaluation failed")

    def export_prediction(self, *args, **kwargs):
        pass

    def eval_map(self, *args, **kwargs):
        return {"mAP": 0.5}


def read_batch(inputs, name):
    out = {"image": inputs[f"{name}/image"],
           "labels": [inputs[f"{name}/labels/{i}"] for i in range(3)],
           "boxes": inputs[f"{name}/boxes"]}
    if f"{name}/mask" in inputs:
        out["mask"] = inputs[f"{name}/mask"]
    return out


def config_of(kw):
    from yolov4tpu_torch.config import YoloConfig
    return YoloConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in kw.items()})


def main():
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    work = pathlib.Path(work)
    torch.set_num_threads(1)
    # tensorboard's no-TensorFlow mode (its stub file writer): where
    # TensorFlow is installed, tensorboard imports it, which takes ~13 s.
    sys.modules["tensorboard.compat.notf"] = types.ModuleType(
        "tensorboard.compat.notf")
    import torch.distributed as dist

    from yolov4tpu_torch import train
    from yolov4tpu_torch.callbacks import CheckpointCallback, EvalMapCallback
    from yolov4tpu_torch.data.pipeline import DataGenerator
    from yolov4tpu_torch.parallel import (init_distributed, make_mesh,
                                          shard_batch)

    info = init_distributed(f"file://{work / 'store'}", world, rank,
                            backend="gloo")
    assert info["num_processes"] == world and info["backend"] == "gloo", info
    mesh = make_mesh(world, device="cpu")

    counts = {"all_reduce": 0, "slab": 0, "all_gather": 0}
    real_all_reduce, real_slab = dist.all_reduce, train._allreduce_slab
    real_all_gather = dist.all_gather

    def counted_all_reduce(*a, **k):
        counts["all_reduce"] += 1
        return real_all_reduce(*a, **k)

    def counted_slab(*a, **k):
        counts["slab"] += 1
        return real_slab(*a, **k)

    def counted_all_gather(*a, **k):
        counts["all_gather"] += 1
        return real_all_gather(*a, **k)

    dist.all_reduce = counted_all_reduce
    train._allreduce_slab = counted_slab
    dist.all_gather = counted_all_gather

    spec = json.loads((work / "spec.json").read_text())
    num_classes = spec["num_classes"]
    start = torch.load(work / "params.pt", weights_only=True)
    params0, state0 = start["params"], start["state"]
    inputs = dict(np.load(work / "inputs.npz"))
    out = {}

    def fresh():
        return (train.tree_map(lambda t: t.clone(), params0),
                train.tree_map(lambda t: t.clone(), state0))

    def optimizer_of(sc, cfg):
        if sc.get("optimizer") == "sgd":
            return lambda tensors: SGD(tensors, cfg.learning_rate)
        return None

    def record(name, params, state, metrics=None):
        for i, t in enumerate(train.leaves(params)):
            out[f"{name}/params/{i}"] = t.detach().numpy()
        for i, t in enumerate(train.leaves(state)):
            out[f"{name}/state/{i}"] = t.detach().numpy()
        for k, v in (metrics or {}).items():
            out[f"{name}/metrics/{k}"] = np.asarray(float(v))
        for k, v in counts.items():
            out[f"{name}/{k}"] = np.asarray(v)

    for sc in spec["scenarios"]:
        dist.barrier()
        for k in counts:
            counts[k] = 0
        cfg = config_of(sc["config"])
        name, kind = sc["name"], sc["kind"]
        t0 = time.perf_counter()
        if kind in ("step", "twophase"):
            params, state = fresh()
            tensors = train.leaves(params)
            make_opt = optimizer_of(sc, cfg)
            opt = (make_opt(tensors) if make_opt is not None
                   else train.make_optimizer(cfg, tensors))
            if kind == "step":
                step = train.make_train_step(num_classes, cfg, opt, mesh,
                                             masked=sc.get("masked", False))
            else:
                step = train.make_train_step_twophase(num_classes, cfg, opt,
                                                      mesh)
            batch = read_batch(inputs, sc["batch"])
            state, metrics = step(params, state, shard_batch(batch, mesh))
            record(name, params, state, metrics)
        elif kind == "trainer":
            params, state = fresh()
            tr = train.Trainer(cfg, num_classes, params, state, mesh=mesh,
                               optimizer=optimizer_of(sc, cfg))
            metrics = {}
            for b in sc.get("batches", []):
                metrics = tr.train_step(read_batch(inputs, b))
            for i, b in enumerate(sc.get("eval", [])):
                metrics[f"eval{i}"] = tr.eval_step(read_batch(inputs, b))
            record(name, tr.params, tr.state, metrics)
        elif kind == "fit":
            folder, classes = sc["folder"], sc["classes"]
            lines = sc["lines"]
            seed = sc["seed"] + (rank if sc.get("seed_per_rank") else 0)

            def gen(ls, seed, shuffle=True):
                return DataGenerator(ls, classes, folder, config=cfg,
                                     seed=seed, shuffle=shuffle,
                                     use_native=False)

            resume = work / name / "resume"
            tr = train.Trainer(cfg, num_classes, *fresh(), device="cpu")
            ck = CheckpointCallback(
                str(work / name / f"ck_r{rank}_{{epoch}}.npz"))
            printed = io.StringIO()
            try:
                with contextlib.redirect_stdout(printed):
                    tr.fit(gen(lines, seed), epochs=1,
                           val_gen=gen(sc["val_lines"], 1, shuffle=False),
                           callbacks=[ck], resume_dir=str(resume),
                           verbose=True)
            except RuntimeError as e:
                out[f"{name}/error"] = np.asarray(str(e))
                continue
            out[f"{name}/printed"] = np.asarray(len(printed.getvalue()))
            out[f"{name}/steps"] = np.asarray(tr.global_step)
            out[f"{name}/val_loss"] = np.asarray(tr.history[0]["val_loss"])
            record(name, tr.params, tr.state)
            # A fresh trainer's fit with the same resume_dir restores the
            # checkpoint and, at epochs=1, trains no further.
            resumed = train.Trainer(cfg, num_classes, *fresh(), device="cpu")
            resumed.fit(gen(lines, seed), epochs=1, resume_dir=str(resume),
                        verbose=False)
            out[f"{name}/resumed_steps"] = np.asarray(resumed.global_step)
            record(f"{name}_resumed", resumed.params, resumed.state)
        elif kind == "rank0_eval":
            # The steps' collectives time out after sc["timeout"] s; rank 0's
            # first evaluation takes sc["sleep"] s, its second one raises.
            short = dist.new_group(backend="gloo", timeout=datetime.timedelta(
                seconds=sc["timeout"]))
            tr = train.Trainer(cfg, num_classes, *fresh(),
                               mesh=dataclasses.replace(mesh, group=short))
            for i, (seconds, fail) in enumerate(
                    ((sc["sleep"] if rank == 0 else 0.0, False), (0.0, True))):
                cb = EvalMapCallback(SlowEvaluator(seconds, fail), "val.txt",
                                     "images", str(work / name / str(rank)),
                                     every=1, verbose=0)
                t1 = time.perf_counter()
                try:
                    cb(tr, {"epoch": 0})
                except (RuntimeError, ValueError) as e:
                    out[f"{name}/error{i}"] = np.asarray(
                        f"{type(e).__name__}: {e}")
                out[f"{name}/waited{i}"] = np.asarray(time.perf_counter() - t1)
                out[f"{name}/evaluations{i}"] = np.asarray(len(cb.history))
                metrics = tr.train_step(read_batch(inputs, sc["batch"]))
                record(f"{name}{i}", tr.params, tr.state, metrics)
        elif kind == "distribute":
            from yolov4tpu_torch.api import Yolov4
            from yolov4tpu_torch.utils.metrics import MetricsLogger
            model = Yolov4(None, sc["classes"], config=cfg, device="cpu")
            params, state = fresh()
            if rank:
                params = train.tree_map(lambda t: t + sc["offset"], params)
            model.sync_params(params, state)
            assert model.distribute(world) is model

            def predict(prefix, batches):
                for b in batches:
                    before = counts["all_gather"]
                    outs = model.predict_batch(inputs[b])
                    out[f"{prefix}/{b}/all_gather"] = np.asarray(
                        counts["all_gather"] - before)
                    for i, o in enumerate(outs):
                        out[f"{prefix}/{b}/{i}"] = o.numpy()

            predict(name, sc["batches"])
            model.quantize(calib_imgs=inputs[sc["calib"]])
            predict(f"{name}_int8", sc["batches"])
            model.dequantize()
            before = counts["all_gather"]
            model.export_prediction(sc["annotation"],
                                    str(work / name / f"pred_r{rank}"),
                                    sc["folder"], bs=sc["bs"],
                                    verbose=False)
            out[f"{name}/export_all_gather"] = np.asarray(
                counts["all_gather"] - before)
            # Every file of rank 0 is on disk when the call returns.
            out[f"{name}/rank0_files"] = np.asarray(
                sorted(p.name for p in (work / name / "pred_r0").iterdir()))
            # fit: the trainer (num_devices ranks) starts from rank 0's
            # params; the facade evaluates after each epoch.
            fit = sc["fit"]
            for k in counts:
                counts[k] = 0
            logger = MetricsLogger(str(work / name / "logs"))
            ev = EvalMapCallback(model, fit["annotation"], sc["folder"],
                                 str(work / name / "eval"), every=1,
                                 verbose=0)
            gen = DataGenerator(fit["lines"], sc["classes"], sc["folder"],
                                config=cfg, seed=0, use_native=False)
            history = model.fit(gen, epochs=fit["epochs"],
                                callbacks=[logger, ev], verbose=False)
            logger.close()
            out[f"{name}_fit/losses"] = np.asarray(
                [h["loss"] for h in history])
            out[f"{name}_fit/maps"] = np.asarray(
                [h["mAP"] for h in ev.history])
            record(f"{name}_fit", model.params, model.state)
        else:
            raise ValueError(f"unknown scenario kind {kind!r}")
        out[f"{name}/seconds"] = np.asarray(time.perf_counter() - t0)

    dist.barrier()
    np.savez(work / f"out_{rank}.npz", **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
