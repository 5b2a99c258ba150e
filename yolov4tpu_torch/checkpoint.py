"""Checkpoints: ``.npz`` files in the JAX package's layout, and directory
checkpoints with ``torch.distributed.checkpoint``.

Counterpart of ``yolov4tpu.checkpoint``:

  - ``save_npz``/``load_npz``: one dependency-free file of (params, state)
    and a step counter, with the JAX package's keys (``params/...``,
    ``state/...``, ``meta/step``, ``meta/extra_json``), shapes and dtypes,
    so a file that either package writes loads in the other.
    ``save_npz`` takes the JAX layout (numpy arrays, HWIO kernels; the
    port's tensors go through ``network.params_to_jax`` first), and
    ``load_npz`` gives the port's (CPU tensors, OIHW kernels, as
    ``network.params_from_jax`` gives them);
  - ``save_dcp``/``load_dcp``/``latest_dcp_step``: the counterparts of
    ``save_orbax``/``load_orbax``/``latest_orbax_step``, in the same
    ``step_{n}`` directory layout, written and read by
    ``torch.distributed.checkpoint`` in one process.  Such a directory is
    DCP's format, not orbax's: neither package reads the other's, and it
    holds the port's tensors as they are (OIHW kernels);
  - darknet ``.weights`` import/export and keras ``.h5`` import live in
    weights.py.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .device import resolve_device


def _flatten(tree, prefix="", leaf=np.asarray) -> Dict[str, Any]:
    """Nested dicts and lists -> {"a/0/b": leaf}; a None entry becomes
    "<prefix>__none__" holding an empty array."""
    flat = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            flat.update(_flatten(v, f"{prefix}{k}/", leaf))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            flat.update(_flatten(v, f"{prefix}{i}/", leaf))
    elif tree is None:
        flat[prefix + "__none__"] = leaf(np.zeros(0))
    else:
        flat[prefix.rstrip("/")] = leaf(tree)
    return flat


def _unflatten(flat: Dict[str, Any]):
    """The inverse of ``_flatten``: digit keys become lists, a lone
    ``__none__`` key becomes None."""
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val

    def resolve(node):
        if isinstance(node, dict):
            if set(node.keys()) == {"__none__"}:
                return None
            keys = list(node.keys())
            if keys and all(k.isdigit() for k in keys):
                return [resolve(node[str(i)]) for i in range(len(keys))]
            return {k: resolve(v) for k, v in node.items()}
        return node

    return resolve(root)


def _tensors(tree, kernels: bool = False):
    """numpy leaves -> CPU tensors (copies, dtype kept); with ``kernels``,
    float32 and every "w" entry HWIO -> OIHW."""
    if isinstance(tree, dict):
        out = {k: _tensors(v, kernels) for k, v in tree.items()}
        if kernels and "w" in out and out["w"].dim() == 4:
            out["w"] = out["w"].permute(3, 2, 0, 1).contiguous()
        return out
    if isinstance(tree, list):
        return [_tensors(v, kernels) for v in tree]
    if tree is None:
        return None
    t = torch.from_numpy(np.array(tree))
    return t.to(torch.float32) if kernels else t


def save_npz(path: str, params, state, step: int = 0,
             extra: Optional[dict] = None):
    """Save (params, state[, metadata]) to one .npz file.  ``params`` and
    ``state`` are in the JAX layout (``network.params_to_jax``)."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    flat = {}
    flat.update({f"params/{k}": v for k, v in _flatten(params).items()})
    flat.update({f"state/{k}": v for k, v in _flatten(state).items()})
    flat["meta/step"] = np.asarray(step)
    if extra:
        flat["meta/extra_json"] = np.frombuffer(
            json.dumps(extra).encode(), dtype=np.uint8)
    np.savez(path, **flat)


def _read_npz(path: str) -> Tuple[dict, dict, int, dict]:
    """A .npz checkpoint as the JAX package's ``load_npz`` reads it ->
    (params, state, step, extra) with numpy leaves (HWIO kernels)."""
    params_flat, state_flat = {}, {}
    step, extra = 0, {}
    with np.load(path, allow_pickle=False) as data:
        for k in data.files:
            if k.startswith("params/"):
                params_flat[k[len("params/"):]] = data[k]
            elif k.startswith("state/"):
                state_flat[k[len("state/"):]] = data[k]
            elif k == "meta/step":
                step = int(data[k])
            elif k == "meta/extra_json":
                extra = json.loads(bytes(data[k].tobytes()).decode())
    return _unflatten(params_flat), _unflatten(state_flat), step, extra


def load_npz(path: str) -> Tuple[dict, dict, int, dict]:
    """Load a .npz checkpoint -> (params, state, step, extra): params as
    float32 CPU tensors with OIHW kernels, state's leaves as CPU tensors of
    the stored dtypes (a trainer checkpoint's optimizer leaves stay in the
    JAX layout: ``Trainer.restore_checkpoint`` maps them)."""
    params, state, step, extra = _read_npz(path)
    return _tensors(params, kernels=True), _tensors(state), step, extra


def save_dcp(directory: str, params, state, step: int = 0):
    """Save (params, state) tensors, on any device, to
    ``directory/step_{step}`` with ``torch.distributed.checkpoint``; an
    existing checkpoint of that step is replaced.  Needs no process
    group."""
    import torch.distributed.checkpoint as dcp

    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    shutil.rmtree(path, ignore_errors=True)
    flat = _flatten({"params": params, "state": state}, leaf=torch.as_tensor)
    dcp.save(flat, checkpoint_id=path)


def load_dcp(directory: str, step: int, device="cuda"):
    """Load ``directory/step_{step}`` written by ``save_dcp`` -> (params,
    state), tensors on ``device`` (the card unless the caller asks for the
    CPU)."""
    import torch.distributed.checkpoint as dcp

    device = resolve_device(device)
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    meta = dcp.FileSystemReader(path).read_metadata()
    flat = {k: torch.empty(m.size, dtype=m.properties.dtype, device=device)
            for k, m in meta.state_dict_metadata.items()}
    dcp.load(flat, checkpoint_id=path)
    tree = _unflatten(flat)
    return tree["params"], tree["state"]


def latest_dcp_step(directory: str) -> Optional[int]:
    """The largest n of the ``step_{n}`` checkpoints in ``directory``, or
    None when there are none or the directory does not exist."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_")]
    return max(steps) if steps else None
