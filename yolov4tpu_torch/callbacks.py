"""Training callbacks (reference custom_callbacks.py:5-15 equivalent).

Counterpart of ``yolov4tpu.callbacks``: the epoch-wise cosine LR
callback, the in-training mAP evaluation and the checkpoint callback, for
``Trainer.fit`` (or a hand-rolled loop that calls them).  Under
data-parallel training the two that write files do so on rank 0 only, and
every rank calls them: the others wait for rank 0 (``parallel.on_rank0``).
"""

from __future__ import annotations

import math
import os

from .parallel.mesh import on_rank0


class CosineAnnealingScheduler:
    """Epoch-wise cosine annealing with restarts, as a Trainer callback.

    lr = lr_min + (lr_max - lr_min) * (1 + cos(pi * (epoch % T) / T)) / 2
    (reference custom_callbacks.py:13-15, which mutates the keras
    optimizer's LR each epoch).

    It drives the optimizer through ``Trainer.set_learning_rate``, and
    raises if the Trainer was built with a schedule or a custom or fused
    optimizer: then the schedule route (``train.cosine_annealing_schedule``)
    is the one in charge, and mixing the two would silently fight.
    """

    def __init__(self, lr_max: float, lr_min: float, cycle_epochs: int,
                 verbose: int = 0):
        self.lr_max = lr_max
        self.lr_min = lr_min
        self.cycle_epochs = cycle_epochs
        self.verbose = verbose
        self.history = []

    def lr(self, epoch: int) -> float:
        t = (epoch % self.cycle_epochs) / self.cycle_epochs
        return self.lr_min + (self.lr_max - self.lr_min) * (
            1 + math.cos(math.pi * t)) / 2

    def on_epoch_begin(self, trainer, epoch: int):
        """Set this epoch's LR before its first step (keras on_epoch_begin
        semantics: epoch 0 trains at lr_max).  Trainer.fit calls this;
        hand-rolled loops should call it at each epoch's start too."""
        self._begin_driven = True
        lr = self.lr(epoch)
        trainer.set_learning_rate(lr)
        self.history.append(lr)
        if self.verbose:
            print(f"CosineAnnealingScheduler: epoch {epoch} lr {lr:.6g}")

    def __call__(self, trainer, entry: dict):
        # Epoch-end hook: set the next epoch's LR.  Under Trainer.fit this
        # is redundant (on_epoch_begin sets the same value and keeps the
        # history); in a hand-rolled loop that only calls callbacks, it
        # keeps the schedule running from epoch 1 on (epoch 0 then trains
        # at the optimizer's base LR).
        lr = self.lr(entry["epoch"] + 1)
        trainer.set_learning_rate(lr)
        if not getattr(self, "_begin_driven", False):
            self.history.append(lr)
            if self.verbose:
                print(f"CosineAnnealingScheduler: epoch "
                      f"{entry['epoch'] + 1} lr {lr:.6g}")


class EvalMapCallback:
    """Run the mAP pipeline (export predictions on a held-out annotation
    file -> the Cartucho-style scorer) every N epochs during training,
    recording {'epoch', 'mAP', per-class APs} in ``history``.

    ``model`` is the owning :class:`yolov4tpu_torch.api.Yolov4`; its
    inference weights are synced from the trainer that drives the loop
    before each evaluation.  On a mesh only rank 0 evaluates (and keeps
    ``history``); the other ranks wait for it without the process group's
    collective timeout, however long the evaluation takes.  A facade
    sharded over the ranks (``Yolov4.distribute``) makes its weight sync
    and predictions collectives: then every rank syncs and predicts, and
    rank 0 alone writes the files and scores them.
    """

    def __init__(self, model, annotation_path: str, img_folder_path: str,
                 work_dir: str, every: int = 5, verbose: int = 1):
        self.model = model
        self.annotation_path = annotation_path
        self.img_folder_path = img_folder_path
        self.work_dir = work_dir
        self.every = every
        self.verbose = verbose
        self.history = []

    def __call__(self, trainer, entry: dict):
        epoch = entry["epoch"]
        if (epoch + 1) % self.every == 0:
            mesh = getattr(self.model, "_mesh", None)
            if mesh is not None:
                self._evaluate(trainer, epoch, mesh)
            else:
                on_rank0(getattr(trainer, "mesh", None),
                         lambda: self._evaluate(trainer, epoch))

    def _evaluate(self, trainer, epoch: int, mesh=None):
        """The evaluation; with the facade's ``mesh``, every rank of it
        calls this and rank 0 alone writes and scores."""
        # The trainer driving this loop may be a hand-built one the facade
        # never saw.
        self.model.sync_from_trainer(trainer)
        gt = os.path.join(self.work_dir, "ground_truth")
        pred = os.path.join(self.work_dir, "pred_result")

        def ground_truth():
            for d in (gt, pred):
                os.makedirs(d, exist_ok=True)
            self.model.export_gt(self.annotation_path, gt)

        on_rank0(mesh, ground_truth)
        self.model.export_prediction(self.annotation_path, pred,
                                     self.img_folder_path,
                                     verbose=self.verbose > 1)
        on_rank0(mesh, lambda: self._score(epoch, gt, pred))

    def _score(self, epoch: int, gt: str, pred: str):
        scores = self.model.eval_map(
            gt, pred, os.path.join(self.work_dir, "json"),
            os.path.join(self.work_dir, "result"),
            plot=False, verbose=self.verbose > 1)
        self.history.append({"epoch": epoch, **scores})
        if self.verbose:
            print(f"EvalMapCallback: epoch {epoch} mAP {scores['mAP']:.4f}")


class CheckpointCallback:
    """Save an .npz checkpoint of (params, BN state) every N epochs, in the
    JAX package's layout (``checkpoint.save_npz``); on a mesh, rank 0's."""

    def __init__(self, path_fmt: str, every: int = 1):
        self.path_fmt = path_fmt
        self.every = every

    def __call__(self, trainer, entry: dict):
        epoch = entry["epoch"]
        if (epoch + 1) % self.every == 0:
            on_rank0(getattr(trainer, "mesh", None),
                     lambda: self._save(trainer, epoch))

    def _save(self, trainer, epoch: int):
        from . import checkpoint as ckpt
        from .models.network import params_to_jax
        params, state = params_to_jax(trainer.params, trainer.state)
        ckpt.save_npz(self.path_fmt.format(epoch=epoch), params, state,
                      step=trainer.global_step, extra={"epoch": epoch})
