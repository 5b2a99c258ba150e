"""Training's BatchNorm + activation of a conv: one autograd op whose
forward and backward are hand-written CUDA (csrc/bn_act.cu).

``bn_act(y, gamma, beta, mean, var, activation, sample_mask,
stats_gradient)`` returns ``(out, new_mean, new_var)``: ``out`` is
``act(y * scale + shift)`` for the NCHW conv output ``y`` normalised by
its own batch statistics (per channel over N, H, W; with a (B,) 0/1
``sample_mask`` over the valid samples only), ``scale`` and ``shift`` in
``y``'s dtype as the eager chain rounds them, and ``new_mean``,
``new_var`` the moving statistics after this batch (momentum 0.99).
``stats_gradient=False`` makes the batch statistics constants of the
backward.  The activation is "mish" or "leaky" (every BN conv of YOLOv4
ends in one of them).

A CUDA tensor in bfloat16 or float32 runs the autograd Function
``_BnAct``: two passes over ``y`` forward (the statistics, then ``out``)
and two over the incoming gradient and ``y`` backward (the per-channel
sums, then ``dy``), saving only ``y`` and a few (C,) float32 vectors.
Given the same scale and shift, ``out`` is bit for bit the eager
``_activate(y * scale + shift)``; the backward keeps float32 from the
gradient to ``dy`` (closer to float32 autograd than the eager bf16
autograd).  A tensor on any other device runs ``bn_act_reference``, the
eager chain itself (``batch_norm_train`` then ``_activate``), which the
JAX parity tests hold to the JAX package.  No setting chooses between
them: the route is the input's device.

``LAUNCHES`` counts the forwards that took the kernels and
``GRAD_LAUNCHES`` the backwards; the training step's ``forward`` and
``backward`` spans report them as ``bn_act`` and ``bn_act_grad``.  The
kernels are built by ``ops.build`` at first use (``Trainer`` builds them
when it is made on the card).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import threading

import torch

from . import build as kbuild
from .epilogue import _activate

BN_EPS = 1e-3  # Keras BatchNormalization default epsilon
BN_MOMENTUM = 0.99  # Keras BatchNormalization default momentum

# Forwards and backwards that launched the kernels.
LAUNCHES = 0
GRAD_LAUNCHES = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ACTIVATIONS = {"leaky": 1, "mish": 2}   # the kernels' codes
_STAT_ROWS = 6   # the forward's saved (C,) rows (csrc/bn_act.cu)
_GRAD_ROWS = 4   # dgamma, dbeta and the statistics' two terms

# Devices whose bf16 mish table bn_act_init has filled.
_TABLES = set()
_tables_lock = threading.Lock()

_F = ctypes.c_float
_I = ctypes.c_int
_I64 = ctypes.c_int64
_P = ctypes.c_void_p


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(kbuild.build("bn_act")))
    lib.bn_act_max_blocks.argtypes = [_I]
    lib.bn_act_max_blocks.restype = _I
    lib.bn_act_init.argtypes = [_P]
    lib.bn_act_init.restype = _I
    lib.bn_act_forward.argtypes = [
        _P, _P, _I64, _I, _I64, _I, _I, _P, _I, _P, _P, _P, _P, _F, _F, _P,
        _P, _P, _P, _I, _I, _P]
    lib.bn_act_forward.restype = _I
    lib.bn_act_backward.argtypes = [
        _P, _I64, _P, _P, _I64, _I, _I64, _I, _I, _P, _P, _P, _I, _P, _P, _I,
        _P]
    lib.bn_act_backward.restype = _I
    return lib


@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return _library().bn_act_max_blocks(sms)


def _mish_table(device) -> bool:
    """Whether the bf16 mish table of CUDA ``device`` may be read: fills
    it at the device's first call that is not captured into a CUDA graph
    (the fill is waited for, once per device and process)."""
    if device.index in _TABLES:
        return True
    if torch.cuda.is_current_stream_capturing():
        return False
    with _tables_lock:
        if device.index not in _TABLES:
            err = _library().bn_act_init(
                torch.cuda.current_stream(device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"bn_act_init failed: CUDA error {err}")
            _TABLES.add(device.index)
    return True


def _check(y, gamma, beta, mean, var, activation, sample_mask):
    if y.dtype not in _DTYPES:
        raise TypeError(f"bn_act takes bfloat16 or float32 tensors, not "
                        f"{y.dtype}")
    if y.dim() != 4:
        raise ValueError(f"y must be (N, C, H, W), got {tuple(y.shape)}")
    c, dev = y.shape[1], y.get_device()
    for name, v in (("gamma", gamma), ("beta", beta), ("mean", mean),
                    ("var", var)):
        if v.shape != (c,) or v.get_device() != dev:
            raise ValueError(f"{name} must be ({c},) on {y.device}, got "
                             f"{tuple(v.shape)} on {v.device}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"activation must be one of {sorted(ACTIVATIONS)}, "
                         f"got {activation!r}")
    if sample_mask is not None and (sample_mask.shape != (y.shape[0],)
                                    or sample_mask.get_device() != dev):
        raise ValueError(f"sample_mask must be ({y.shape[0]},) on "
                         f"{y.device}, got {tuple(sample_mask.shape)} on "
                         f"{sample_mask.device}")


def bn_act(y, gamma, beta, mean, var, activation: str, sample_mask=None,
           stats_gradient: bool = True):
    """``(act(BN(y)), new_mean, new_var)`` with the batch's statistics: y
    (N, C, H, W) bfloat16 or float32; gamma, beta, the moving mean and
    var (C,).  A CUDA tensor runs the kernels (and raises if a launch
    fails), ``out`` in channels_last memory; a tensor on another device
    runs ``bn_act_reference``."""
    _check(y, gamma, beta, mean, var, activation, sample_mask)
    if y.device.type != "cuda":
        return bn_act_reference(y, gamma, beta, mean, var, activation,
                                sample_mask, stats_gradient)
    return _BnAct.apply(y, gamma.float(), beta.float(), mean, var,
                        sample_mask, activation, stats_gradient)


class _BnAct(torch.autograd.Function):
    """The CUDA route of ``bn_act``.  Saves ``y``, gamma, the forward's
    (C,) rows (mean, E[y^2] - E[y]^2, inv, scale, shift, denominator) and
    the mask; the backward recomputes the activation's input from them."""

    @staticmethod
    def forward(ctx, y, gamma, beta, mean, var, sample_mask, activation,
                stats_gradient):
        y = y.contiguous(memory_format=torch.channels_last)
        mask = None if sample_mask is None \
            else sample_mask.to(torch.float32).contiguous()
        out, stats, new_mean, new_var = bn_act_forward(
            y, gamma, beta, mean, var, activation, mask)
        ctx.save_for_backward(y, gamma, stats, mask)
        ctx.activation = activation
        ctx.stats_gradient = stats_gradient
        ctx.mark_non_differentiable(new_mean, new_var)
        return out, new_mean, new_var

    @staticmethod
    def backward(ctx, g, _g_mean, _g_var):
        y, gamma, stats, mask = ctx.saved_tensors
        if g is None:
            g = torch.zeros_like(y)
        dy, grads = bn_act_backward(g, y, gamma, stats, ctx.activation,
                                    mask, ctx.stats_gradient)
        return dy, grads[0], grads[1], None, None, None, None, None


def _f32(v):
    """(C,) ``v`` as contiguous float32 (itself when it is one)."""
    if v.dtype == torch.float32 and v.is_contiguous():
        return v
    return v.detach().to(torch.float32).contiguous()


def _rows(t):
    """(t, ld): ``t`` (N, C, H, W) read as rows of C contiguous channels,
    ``ld`` values apart (channels_last memory, or a channel slice of it);
    other layouts are copied into channels_last."""
    n, c, h, w = t.shape
    s0, s1, s2, s3 = t.stride()
    ld = s3 if w > 1 else s2 if h > 1 else s0 if n > 1 else c
    ok = ((c == 1 or s1 == 1) and ld >= c and (w == 1 or s3 == ld)
          and (h == 1 or s2 == w * ld) and (n == 1 or s0 == h * w * ld))
    if ok:
        return t, ld
    return t.contiguous(memory_format=torch.channels_last), c


def _current(dev):
    """Makes CUDA ``dev`` the current device for a launch, where it is
    not already."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def bn_act_forward(y, gamma, beta, mean, var, activation: str, mask=None):
    """The forward's kernels on CUDA ``y`` (channels_last): (out, stats,
    new_mean, new_var), stats the (6, C) float32 rows the backward reads,
    row 3 the scale and row 4 the shift as the kernel applied them.
    ``mask``: None or (B,) float32."""
    global LAUNCHES
    n, c, h, w = y.shape
    dev = y.device
    f32 = dict(dtype=torch.float32, device=dev)
    out = torch.empty_like(y, memory_format=torch.channels_last)
    stats = torch.empty((_STAT_ROWS, c), **f32)
    new_mean = torch.empty((c,), **f32)
    new_var = torch.empty((c,), **f32)
    blocks = _max_blocks(dev.index)
    work = torch.empty((blocks * 2 * c,), **f32)
    vectors = [_f32(v).data_ptr() for v in (gamma, beta, mean, var)]
    with _current(dev):
        table = (activation == "mish" and y.dtype == torch.bfloat16
                 and _mish_table(dev))
        err = _library().bn_act_forward(
            y.data_ptr(), out.data_ptr(), n * h * w, c, h * w,
            _DTYPES[y.dtype], ACTIVATIONS[activation],
            None if mask is None else mask.data_ptr(), n, *vectors,
            BN_MOMENTUM, 1 - BN_MOMENTUM, stats.data_ptr(),
            new_mean.data_ptr(), new_var.data_ptr(), work.data_ptr(),
            blocks, int(table), torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"bn_act_forward failed: CUDA error {err}")
    LAUNCHES += 1
    return out, stats, new_mean, new_var


def bn_act_backward(g, y, gamma, stats, activation: str, mask=None,
                    stats_gradient: bool = True):
    """The backward's kernels: (dy in channels_last, grads), grads the
    (4, C) float32 rows dgamma, dbeta and the statistics' two terms."""
    global GRAD_LAUNCHES
    n, c, h, w = y.shape
    dev = y.device
    if g.dtype != y.dtype:
        g = g.to(y.dtype)
    g, ld = _rows(g)
    dy = torch.empty_like(y, memory_format=torch.channels_last)
    grads = torch.empty((_GRAD_ROWS, c), dtype=torch.float32, device=dev)
    blocks = _max_blocks(dev.index)
    work = torch.empty((blocks * 2 * c,), dtype=torch.float32, device=dev)
    gamma = _f32(gamma)
    with _current(dev):
        err = _library().bn_act_backward(
            g.data_ptr(), ld, y.data_ptr(), dy.data_ptr(), n * h * w, c,
            h * w, _DTYPES[y.dtype], ACTIVATIONS[activation],
            None if mask is None else mask.data_ptr(), gamma.data_ptr(),
            stats.data_ptr(), int(stats_gradient), grads.data_ptr(),
            work.data_ptr(), blocks,
            torch._C._cuda_getCurrentRawStream(dev.index))
    if err != 0:
        raise RuntimeError(f"bn_act_backward failed: CUDA error {err}")
    GRAD_LAUNCHES += 1
    return dy, grads


# ---------------------------------------------------------------------------
# The plain version: the eager chain
# ---------------------------------------------------------------------------

class _BatchMoments(torch.autograd.Function):
    """Per-channel (E[y], E[y^2]) over (N, H, W) of NCHW ``y``, both in
    float32 from the float32 values of ``y``.  Autograd of
    ``y.float().square().mean()`` would keep a float32 copy of every BN
    input for the backward; this keeps ``y`` itself (in its compute dtype,
    which the conv keeps anyway): d/dy = (g_mean + 2 y g_mean2) / count."""

    @staticmethod
    def forward(ctx, y):
        ctx.save_for_backward(y)
        yf = y.float()
        return yf.mean(dim=(0, 2, 3)), yf.square().mean(dim=(0, 2, 3))

    @staticmethod
    def backward(ctx, g_mean, g_mean2):
        (y,) = ctx.saved_tensors
        count = y.numel() // y.shape[1]
        g = (g_mean.view(1, -1, 1, 1)
             + 2.0 * y.float() * g_mean2.view(1, -1, 1, 1)) / count
        return g.to(y.dtype)


def moments(y, sample_mask=None):
    """Batch mean and E[y^2] per channel in one pass each, float32
    accumulation (network.py:228-254 of the JAX package); with a (B,) 0/1
    ``sample_mask``, over the valid samples."""
    if sample_mask is None:
        return _BatchMoments.apply(y)
    ys = y * sample_mask.to(y.dtype)[:, None, None, None]
    # max(n, 1): an all-padding micro-batch must give finite stats,
    # which the caller discards.
    n_valid = sample_mask.sum(dtype=torch.float32)
    denom = torch.clamp(n_valid, min=1.0) * (y.shape[2] * y.shape[3])
    mean = ys.sum(dim=(0, 2, 3), dtype=torch.float32) / denom
    # All-padding: unit variance instead of zero, so the throwaway
    # forward does not blow up by rsqrt(eps) per layer.
    mean2 = (ys.float().square().sum(dim=(0, 2, 3)) / denom
             + torch.where(n_valid > 0, 0.0, 1.0))
    return mean, mean2


def batch_norm_train(y, gamma, beta, mean, var, sample_mask=None,
                     stats_gradient: bool = True):
    """The eager BN of ``y`` by its batch statistics: (y * scale + shift,
    new_mean, new_var), scale and shift rounded to y's dtype, the moving
    statistics after this batch detached."""
    m, m2 = moments(y, sample_mask)
    if not stats_gradient:
        # YoloConfig.bn_stats_gradient=False: batch statistics are
        # constants in the backward pass.
        m, m2 = m.detach(), m2.detach()
    v = torch.clamp(m2 - m.square(), min=0.0)
    new_mean = (BN_MOMENTUM * mean + (1 - BN_MOMENTUM) * m).detach()
    new_var = (BN_MOMENTUM * var + (1 - BN_MOMENTUM) * v).detach()
    inv = torch.rsqrt(v + BN_EPS)
    scale = (gamma * inv).to(y.dtype)
    shift = (beta - m * gamma * inv).to(y.dtype)
    return (y * scale.view(1, -1, 1, 1) + shift.view(1, -1, 1, 1),
            new_mean, new_var)


def bn_act_reference(y, gamma, beta, mean, var, activation: str,
                     sample_mask=None, stats_gradient: bool = True):
    """The plain version: ``batch_norm_train`` then ``_activate``, the
    eager chain that every BN conv of the training forward ran before the
    kernels (and still runs off the card)."""
    z, new_mean, new_var = batch_norm_train(y, gamma, beta, mean, var,
                                            sample_mask, stats_gradient)
    return _activate(z, activation), new_mean, new_var
