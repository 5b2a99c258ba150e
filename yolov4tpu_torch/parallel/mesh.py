"""The data-parallel mesh over ``torch.distributed`` (counterpart of
``yolov4tpu.parallel.mesh``).

The reference's only parallelism is a tf.distribute.MirroredStrategy scope
(reference models.py:41-44, synchronous NCCL data-parallel).  The JAX
package runs one controller over a ``jax.sharding.Mesh`` and lets
``shard_map`` place the collectives.  The port runs one process per rank,
each on its own device: a ``Mesh`` is this process's view of the group
(its rank, the world size, its device and the process group), batches are
split into contiguous row blocks as ``P("data")`` splits them, parameters
are replicated, and the train step makes its one all-reduce itself
(``train._allreduce_slab``).  Only ``all_reduce``, ``broadcast`` and
``barrier`` are used: gloo runs all three on CUDA tensors too.  What rank
0 alone does between steps (an evaluation, a checkpoint) runs through
``on_rank0``, while the other ranks wait without the steps' timeout.

Recipe, one process per card::

    torchrun --nproc_per_node=N train.py      # in train.py:
    init_distributed()                        # reads torchrun's variables
    model = Yolov4(..., config=YoloConfig(num_devices=N, ...))
    model.fit(DataGenerator(lines, ..., seed=0), epochs)

Every rank runs the whole (seeded, so identical) generator and keeps its own
rows.  The per-host alternative: ``read_annotation_lines(path,
shard=(rank, size))`` with each rank's own generator over its lines.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import warnings
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

# Environment variables whose presence (with the given predicate on their
# value) says "this process is part of a multi-host rig" even when nothing
# configured the process group: there a silent single-process fallback
# would make every process train alone (no gradient sync, clashing
# checkpoint writes).
_MULTI_HOST_HINTS = (
    ("TPU_WORKER_HOSTNAMES", lambda v: "," in v),     # >1 pod worker
    ("TPU_WORKER_ID", lambda v: True),
    ("MEGASCALE_COORDINATOR_ADDRESS", lambda v: True),
    ("CLOUD_TPU_TASK_ID", lambda v: True),
    ("SLURM_NTASKS", lambda v: v.strip().isdigit() and int(v) > 1),
    ("SLURM_JOB_NUM_NODES", lambda v: v.strip().isdigit() and int(v) > 1),
    ("OMPI_COMM_WORLD_SIZE", lambda v: v.strip().isdigit() and int(v) > 1),
)


def _multi_host_hints() -> list:
    """Names of environment variables suggesting this host is one of
    several."""
    return [name for name, pred in _MULTI_HOST_HINTS
            if name in os.environ and pred(os.environ[name])]


# How long the other ranks wait while rank 0 alone does host work between
# steps (an in-training mAP evaluation, a checkpoint): far past the process
# group's collective timeout, which bounds only the steps' collectives.
RANK0_WAIT = datetime.timedelta(hours=6)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a 1-D data-parallel mesh: ``rank`` of
    ``size`` ranks (the JAX mesh's ``devices.size``), computing on
    ``device``, over the process ``group`` (None: the default group).
    ``wait_group``: a gloo group of the same ranks whose timeout is
    ``RANK0_WAIT``, where ``on_rank0`` waits (None: ``group``)."""
    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    wait_group: Optional[object] = None


def _backend(backend: Optional[str]) -> str:
    """NCCL for the card, gloo for the CPU; gloo on the card only when
    asked for.  Never swaps one for another."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs CUDA, which this host "
                               "lacks; pass backend='gloo' for the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL")
    elif backend == "gloo":
        if not dist.is_gloo_available():
            raise RuntimeError("this torch build has no gloo")
    else:
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    return backend


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: float = 60.0) -> dict:
    """Join this process to the data-parallel process group; idempotent.

    ``coordinator_address`` is rank 0's "host:port" (or an init URL such as
    "file:///shared/path"), ``num_processes`` the world size and
    ``process_id`` this rank; each falls back to torchrun's MASTER_ADDR +
    MASTER_PORT, WORLD_SIZE and RANK.  With none of them set, a one-rank
    group is made in this process (with a warning, as the JAX package
    continues single-process), unless the environment looks multi-host
    (SLURM, TPU pod or MPI variables): then it raises rather than let every
    process train alone.  ``num_processes=1`` alone makes the one-rank
    group without the warning.

    ``backend``: "nccl" (the default with CUDA) or "gloo" (the default
    without; on the card only when asked for, e.g. for two ranks sharing
    one card, which NCCL refuses).  ``timeout`` (seconds) bounds every
    collective of the steps, so a rank that never arrives fails the run
    instead of hanging it (``on_rank0``'s wait has its own).  On a host
    with CUDA the rank's card becomes the current device (LOCAL_RANK, else
    the rank, modulo the card count).

    Returns {"process_id", "num_processes", "local_devices",
    "global_devices", "backend"}.
    """
    if not dist.is_initialized():
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
        if num_processes is None and "WORLD_SIZE" in os.environ:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None and "RANK" in os.environ:
            process_id = int(os.environ["RANK"])
        kw = {"backend": _backend(backend),
              "timeout": datetime.timedelta(seconds=timeout)}
        rank = process_id or 0
        if torch.cuda.is_available():
            local = int(os.environ.get("LOCAL_RANK", rank))
            torch.cuda.set_device(local % torch.cuda.device_count())
            if kw["backend"] == "nccl":
                kw["device_id"] = torch.device("cuda",
                                               torch.cuda.current_device())
        if coordinator_address is not None or num_processes not in (None, 1):
            if coordinator_address is None or process_id is None \
                    or num_processes is None:
                raise ValueError(
                    "a process group of several ranks needs "
                    "coordinator_address, num_processes and process_id "
                    f"(got {coordinator_address!r}, {num_processes!r}, "
                    f"{process_id!r})")
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group(init_method=url, world_size=num_processes,
                                    rank=process_id, **kw)
        else:
            if num_processes is None:
                hints = _multi_host_hints()
                if hints:
                    raise RuntimeError(
                        "init_distributed: nothing configured the process "
                        "group (no MASTER_ADDR/WORLD_SIZE/RANK, no "
                        "arguments) but the environment looks multi-host "
                        f"(env: {', '.join(hints)}). Refusing the "
                        "single-process fallback: each process would train "
                        "independently — no gradient sync, clashing "
                        "checkpoint writes. Pass coordinator_address/"
                        "num_processes/process_id or run under torchrun.")
                warnings.warn("init_distributed: no process group configured "
                              "(MASTER_ADDR/WORLD_SIZE/RANK unset); continuing "
                              "single-process", stacklevel=2)
            dist.init_process_group(store=dist.HashStore(), world_size=1,
                                    rank=0, **kw)
    return {"process_id": dist.get_rank(),
            "num_processes": dist.get_world_size(),
            "local_devices": 1,
            "global_devices": dist.get_world_size(),
            "backend": dist.get_backend()}


def make_mesh(num_data: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh over every rank of the process group (``init_distributed``
    first), this rank computing on ``device``: the card unless the caller
    asks for the CPU; "cuda" without an index is the current card, which
    ``init_distributed`` set.  ``num_data`` must equal the world size: more
    raises as the JAX package does, fewer too (a mesh here spans the
    whole group).  Every rank makes its mesh at the same point: with more
    than one rank that creates the mesh's ``wait_group``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed() first (or run under torchrun)")
    size = dist.get_world_size()
    if num_data is not None and num_data > size:
        raise ValueError(f"requested {num_data} devices, have {size}")
    if num_data is not None and num_data < size:
        raise ValueError(f"requested {num_data} devices of a process group "
                         f"of {size}: a mesh spans every rank")
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.get_backend() == "nccl" and device.type != "cuda":
        raise ValueError(f"an NCCL process group cannot compute on {device}")
    wait = (dist.new_group(backend="gloo", timeout=RANK0_WAIT)
            if size > 1 else None)
    return Mesh(rank=dist.get_rank(), size=size, device=device,
                wait_group=wait)


def on_rank0(mesh: Optional[Mesh], fn):
    """``fn()`` on rank 0 of ``mesh`` alone (in the one process when
    ``mesh`` is None) while the other ranks wait for it in its
    ``wait_group``, so a long evaluation or write on rank 0 does not run
    the others into the collective timeout of their next step.  Returns
    ``fn()``'s result on rank 0, None elsewhere; when ``fn`` raises on
    rank 0, the other ranks raise too.  Every rank of the mesh calls it at
    the same point."""
    if mesh is None or mesh.size == 1:
        return fn()
    if mesh.wait_group is not None:
        group, failed = mesh.wait_group, torch.zeros(1)
    else:
        group, failed = mesh.group, torch.zeros(1, device=mesh.device)
    result = None
    if mesh.rank == 0:
        try:
            result = fn()
        except BaseException:
            failed.fill_(1)
            dist.broadcast(failed, 0, group=group)
            raise
    dist.broadcast(failed, 0, group=group)
    if failed.item():
        raise RuntimeError("rank 0 failed in the work the other ranks "
                           "waited for (an evaluation or a checkpoint); its "
                           "error is in rank 0's output")
    return result


def shard_batch(batch, mesh: Mesh, batch_axis: int = 0):
    """This rank's contiguous rows of a global host batch (dicts and lists
    of arrays), as ``P("data")`` splits axis ``batch_axis`` (axis 1 for the
    (accum, B/accum, ...) micro-batch stacks of gradient accumulation), on
    the mesh's device: a copy from pinned memory that does not block the
    caller when that is the card."""
    from ..device import to_device_async
    from ..train import tree_map

    def rows(x):
        x = torch.as_tensor(x)
        n = x.shape[batch_axis]
        if n % mesh.size:
            raise ValueError(f"axis {batch_axis} of size {n} does not split "
                             f"into {mesh.size} equal shards")
        k = n // mesh.size
        return to_device_async(x.narrow(batch_axis, mesh.rank * k, k),
                               mesh.device)

    return tree_map(rows, batch)


@torch.no_grad()
def replicate(tree, mesh: Mesh):
    """Give every rank rank 0's values of ``tree`` (float32 or narrower
    floating tensors on the mesh's device), in place: one broadcast of one
    flat float32 buffer.
    Returns ``tree``.  A one-rank mesh has nothing to copy."""
    from ..train import leaves
    tensors = leaves(tree)
    if mesh.size == 1 or not tensors:
        return tree
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.broadcast(flat, 0, group=mesh.group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view(t.shape))
        offset += t.numel()
    return tree
