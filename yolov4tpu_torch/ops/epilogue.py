"""The epilogue of every conv of the folded forward: bias add and
activation, one hand-written CUDA pass (csrc/conv_epilogue.cu).

``conv_epilogue(y, b, activation)`` returns ``act(y + b)`` for a conv's
NCHW output ``y`` and its ``(C,)`` bias ``b`` in ``y``'s dtype, with the
activation "mish", "leaky" or "linear".  A CUDA tensor in bfloat16 or
float32 launches the kernel, in channels_last memory (as every conv
output of the folded forward already is; any other layout is copied into
it first): one read of ``y``, one write of a new tensor, in place of the
eager chain's broadcast add and ten elementwise passes for mish (one for
leaky).  bf16 mish reads each value's result from a table of all 65,536
bf16 values, computed by the same arithmetic and filled once per device
at its first call outside a CUDA graph's capture (that call waits for
the fill); a call captured before that computes mish, the same bits.  A
tensor on any other device runs ``conv_epilogue_reference``, the eager
expression ``_activate(y + _bias(b), activation)`` itself.  The kernel
repeats that expression's float32 operations and bfloat16 roundings in
their order, so the two agree bit for bit (the source's header).  No
setting chooses between them: the route is the input's device.

``conv_epilogue_merge(y, b, s, t)`` is the second mode, for a conv of
YOLOv4-P6 whose output is one half of a concat that a BN + mish follows:
``mish(s * mish(y + b) + t)``, the conv's own folded BN + mish and then
its half of the concat's BN + mish, in the same single pass (the kernel
``epilogue_merge``, a name of its own in a device trace).  Its plain
version is the eager chain ``conv_epilogue_merge_reference``, with
(s, t) in y's dtype as the bias is; the kernel equals it bit for bit.

This module also holds that eager expression's parts: ``_mish``,
``_activate`` and ``_bias``, which ``models.network`` uses in every
forward (training's, and BN inference's, end each conv in them).

The wrapper is a ``torch.library`` custom op
(``yolov4tpu_torch::conv_epilogue``) with a fake implementation, so that
``torch.export`` traces the folded forward through it; a single-platform
CUDA artifact holds it as it holds ``suppress_rank``, and ``serving``
replaces it by ``conv_epilogue_reference`` in any other artifact.
``CALLS`` counts the epilogues run through either op, ``LAUNCHES`` those
of them that took the kernel, ``MERGES`` those in the second mode;
``api.build_infer_fn``'s ``forward`` span reports the three, and
``chip_smoke.py`` reads them.  The kernel is built at
first use by ``ops.build``.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import torch
import torch.nn.functional as F

from . import build as kbuild

# Epilogues run through conv_epilogue or conv_epilogue_merge (either
# route), of them the launches of the CUDA kernel, and those run in the
# second (merge) mode.
CALLS = 0
LAUNCHES = 0
MERGES = 0

ACTIVATIONS = {"linear": 0, "leaky": 1, "mish": 2}   # the kernel's codes
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


# Devices whose bf16 mish table conv_epilogue_init has filled.
_TABLES = set()
_tables_lock = threading.Lock()


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(kbuild.build("conv_epilogue")))
    lib.conv_epilogue_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    lib.conv_epilogue_launch.restype = ctypes.c_int
    lib.conv_epilogue_init.argtypes = [ctypes.c_void_p]
    lib.conv_epilogue_init.restype = ctypes.c_int
    lib.conv_epilogue_merge_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
    lib.conv_epilogue_merge_launch.restype = ctypes.c_int
    return lib


def _mish_table(device) -> bool:
    """Whether the bf16 mish table of the current CUDA ``device`` may be
    read: fills it at the device's first call that is not captured into a
    CUDA graph (the fill is waited for, once per device and process)."""
    if device.index in _TABLES:
        return True
    if torch.cuda.is_current_stream_capturing():
        return False
    with _tables_lock:
        if device.index not in _TABLES:
            err = _library().conv_epilogue_init(
                torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"conv_epilogue_init failed: CUDA error "
                                   f"{err}")
            _TABLES.add(device.index)
    return True


def _check(y, b, activation):
    if y.dtype not in _DTYPES:
        raise TypeError(f"conv_epilogue takes bfloat16 or float32 tensors, "
                        f"not {y.dtype}")
    if b.dtype != y.dtype:
        raise TypeError(f"the bias must be in y's dtype {y.dtype}, got "
                        f"{b.dtype}")
    if y.dim() != 4 or b.shape != (y.shape[1],):
        raise ValueError(f"y must be (N, C, H, W) and b (C,), got "
                         f"{tuple(y.shape)} and {tuple(b.shape)}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if y.device != b.device:
        raise ValueError("y and b must be on one device")


@torch.library.custom_op("yolov4tpu_torch::conv_epilogue", mutates_args=(),
                         schema="(Tensor y, Tensor b, str activation) "
                                "-> Tensor")
def conv_epilogue(y, b, activation):
    """``act(y + b)``: y (N, C, H, W) bfloat16 or float32, b (C,) in y's
    dtype, activation "mish", "leaky" or "linear" -> a new tensor like
    ``y``.  A CUDA tensor launches the kernel (and raises if the launch
    fails), its output in channels_last memory; a tensor on another device
    runs ``conv_epilogue_reference``."""
    global CALLS
    _check(y, b, activation)
    CALLS += 1
    if y.device.type != "cuda":
        return conv_epilogue_reference(y, b, activation)
    return _launch("conv_epilogue_launch", y, (b,),
                   (ACTIVATIONS[activation],), activation == "mish")


def _launch(entry, y, vectors, codes, mish: bool):
    """One launch of the library's ``entry`` over CUDA ``y`` (copied into
    channels_last memory if it is not) and its (C,) ``vectors``: a new
    channels_last tensor.  The entry takes (y, *vectors, out, rows, C,
    dtype code, *codes, table, stream); ``mish``: whether bf16 reads the
    mish table."""
    global LAUNCHES
    y = y.contiguous(memory_format=torch.channels_last)
    vectors = [v.contiguous() for v in vectors]
    out = torch.empty_like(y)        # channels_last, as y
    if out.numel() == 0:
        return out
    with torch.cuda.device(y.device):
        table = (mish and y.dtype == torch.bfloat16
                 and _mish_table(y.device))
        err = getattr(_library(), entry)(
            y.data_ptr(), *(v.data_ptr() for v in vectors), out.data_ptr(),
            y.numel() // y.shape[1], y.shape[1], _DTYPES[y.dtype], *codes,
            int(table), torch.cuda.current_stream(y.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    LAUNCHES += 1
    return out


@conv_epilogue.register_fake
def _conv_epilogue_fake(y, b, activation):
    _check(y, b, activation)
    if y.device.type == "cuda":
        return torch.empty_like(y, memory_format=torch.channels_last)
    return torch.empty_like(y)


@torch.library.custom_op("yolov4tpu_torch::conv_epilogue_merge",
                         mutates_args=(),
                         schema="(Tensor y, Tensor b, Tensor s, Tensor t) "
                                "-> Tensor")
def conv_epilogue_merge(y, b, s, t):
    """``mish(s * mish(y + b) + t)``: y (N, C, H, W) bfloat16 or float32;
    b, s, t (C,) in y's dtype -> a new tensor like ``y``.  Routed as
    ``conv_epilogue``: a CUDA tensor launches the kernel, its output in
    channels_last memory; another device runs
    ``conv_epilogue_merge_reference``."""
    global CALLS, MERGES
    for v in (b, s, t):
        _check(y, v, "mish")
    CALLS += 1
    MERGES += 1
    if y.device.type != "cuda":
        return conv_epilogue_merge_reference(y, b, s, t)
    return _launch("conv_epilogue_merge_launch", y, (b, s, t), (), True)


@conv_epilogue_merge.register_fake
def _conv_epilogue_merge_fake(y, b, s, t):
    return _conv_epilogue_fake(y, b, "mish")


def _mish(x):
    """mish(x) = x * tanh(softplus(x)) via the single-exp identity

        tanh(softplus(x)) = (u^2 + 2u) / (u^2 + 2u + 2),  u = e^x,

    with the exp clamped at 20 (above it mish(x) = x at f32 precision).  The
    same arithmetic, in the same order, as the JAX package; ``F.mish``
    differs from it by up to ~1.5e-4.
    """
    u = torch.exp(torch.clamp(x, max=20.0))
    n = u * u + 2.0 * u
    return torch.where(x > 20.0, x, x * (n / (n + 2.0)))


def _activate(y, activation):
    if activation == "mish":
        return _mish(y)
    if activation == "leaky":
        return F.leaky_relu(y, negative_slope=0.1)
    return y


def _bias(b, dtype):
    """(C,) bias -> (1, C, 1, 1) for NCHW activations.  Added after the conv,
    in the compute dtype, as the JAX forward does (not fused into the conv,
    which would add it before the bf16 output rounding).  The folded
    forward adds it inside the epilogue kernel, still after the conv's
    bf16 rounding, with the same single rounding of the sum."""
    return (b if b.dtype == dtype else b.to(dtype)).view(1, -1, 1, 1)


def conv_epilogue_reference(y, b, activation: str):
    """The plain version: the folded forward's eager expression,
    ``_activate(y + _bias(b, y.dtype), activation)``."""
    return _activate(y + _bias(b, y.dtype), activation)


def conv_epilogue_merge_reference(y, b, s, t):
    """The plain version of the second mode: the eager chain
    ``_activate(_activate(y + b) * s + t)``, mish both times, each
    operation in y's dtype."""
    m = _activate(y + _bias(b, y.dtype), "mish")
    return _activate(m * _bias(s, y.dtype) + _bias(t, y.dtype), "mish")
