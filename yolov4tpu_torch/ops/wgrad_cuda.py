"""3x3 stride-1 SAME convolution whose weight gradient is a hand-written
CUDA kernel.

Counterpart of ``yolov4tpu.ops.wgrad_pallas``.  ``conv3x3_s1`` is a
``torch.autograd.Function`` split as ``_conv3x3_custom`` splits its
custom_vjp: the forward is ``F.conv2d`` and the data gradient PyTorch's own
convolution backward (XLA computes both outside Pallas in the JAX package);
the weight gradient is ``wgrad_3x3_s1``, which launches
``csrc/wgrad_3x3.cu`` on CUDA tensors and runs its plain torch version,
``wgrad_3x3_s1_reference``, on CPU tensors.  Nothing else chooses between
them.  The kernel is built at first use by ``ops.build``.  It has two
routes, chosen by the operand type: bfloat16 runs on the tensor cores
(``mma.sync`` fed by a ``cp.async`` ring, channels padded to multiples of
8), float32 on the CUDA cores in full float32.

The JAX package routes a conv through its kernel only when ``_pick_tiles``
finds a tiling: Ci a multiple of 128 (the TPU's lane width) and tiles that
fit VMEM.  Those are limits of the TPU, and the result does not depend on
them (the fallback is XLA's wgrad of the same conv, within float32
summation order), so the port does not copy them: with
``pallas_wgrad=True`` every 3x3 stride-1 conv of the training forward goes
through this kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import build as kbuild

# Launches of the CUDA kernel (one per wgrad_3x3_s1 call on the card), and
# of those the launches on the bfloat16 tensor-core route; chip_smoke.py
# reads both to show the training path went through the kernel.
LAUNCHES = 0
TC_LAUNCHES = 0

# Split-K sizing of the float32 route: aim for this many blocks per SM over
# the whole grid, and give each split at least this many pixels.
_BLOCKS_PER_SM = 4
_MIN_CHUNK = 512
_MAX_SPLITS = 65535  # gridDim.z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# The tensor-core route: pixels per K step, channels per 16-byte chunk, the
# blocks of each tile that one SM holds at once (registers and the
# shared-memory ring), and the fewest and most K steps a split takes.  The
# mma's float32 accumulation rounds toward zero, so its error grows with
# the chain of products summed into one partial (on the H100, ~1e-9 of the
# largest entry per pixel of the chain: tools/wgrad_probe.py's sweep); 256
# steps (8,192 pixels) keep it near 1e-5, a tenth of chip_smoke.py's
# tolerance.  _TC_STEP and _TC_BLOCKS_PER_SM are the kernel's kTcStep and
# kTcBlocks128/64, checked against the library when it loads.
_TC_STEP = 32
_TC_CHANNELS = 8
_TC_BLOCKS_PER_SM = {128: 2, 64: 4}
_TC_MIN_STEPS = 8
_TC_MAX_STEPS = 256


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(kbuild.build("wgrad_3x3")))
    step, blocks = ctypes.c_int(), ctypes.c_int()
    lib.wgrad_tc_config.restype = None
    for tile, want in _TC_BLOCKS_PER_SM.items():
        lib.wgrad_tc_config(tile, ctypes.byref(step), ctypes.byref(blocks))
        if (step.value, blocks.value) != (_TC_STEP, want):
            raise RuntimeError(
                f"wgrad_3x3.cu has a K step of {step.value} and "
                f"{blocks.value} blocks per SM for tile {tile}; plan() "
                f"assumes {_TC_STEP} and {want}")
    fn = lib.wgrad_3x3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def plan(b: int, h: int, w: int, ci: int, co: int, sms: int, dtype):
    """(tile, splits, chunk) for one launch on operands of ``dtype``.

    The 128 tile where both channel counts reach 128, else 64.  float32
    (CUDA cores): enough K splits that the grid holds ``_BLOCKS_PER_SM``
    blocks per SM, each split at least ``_MIN_CHUNK`` pixels, a multiple of
    16 (a K step of either tile).  bfloat16 (tensor cores, channels padded
    to multiples of 8): each split a whole number of 32-pixel K steps,
    between ``_TC_MIN_STEPS`` and ``_TC_MAX_STEPS`` of them, and the number
    of splits, up to what fills every SM's resident blocks once, that
    takes the fewest K steps in waves x steps per split (a grid just past
    one wave would run a second wave nearly empty)."""
    k = b * h * w
    tc = dtype == torch.bfloat16
    if tc:
        ci, co = _padded(ci), _padded(co)
    tile = 128 if ci >= 128 and co >= 128 else 64
    tiles = -(-(9 * ci) // tile) * -(-co // tile)
    if tc:
        slots = _TC_BLOCKS_PER_SM[tile] * sms
        steps = -(-k // _TC_STEP)
        fewest = -(-steps // _TC_MAX_STEPS)
        most = max(fewest, min(-(-slots // tiles), steps // _TC_MIN_STEPS,
                               _MAX_SPLITS))
        splits = min(range(fewest, most + 1), key=lambda s: (
            -(-tiles * s // slots) * -(-steps // s), s))
        chunk = -(-steps // splits) * _TC_STEP
    else:
        splits = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles),
                            k // _MIN_CHUNK, _MAX_SPLITS))
        chunk = -(-k // splits)
        chunk = -(-chunk // 16) * 16
    return tile, -(-k // chunk), chunk


def _padded(c: int) -> int:
    return -(-c // _TC_CHANNELS) * _TC_CHANNELS


def pad_channels(t):
    """``t`` (..., C) NHWC-contiguous, its channels zero-padded up to a
    multiple of 8 (the tensor-core route's 16-byte chunk) and its storage
    16-byte aligned: ``t`` itself when it already is both, else a copy."""
    pad = _padded(t.shape[-1]) - t.shape[-1]
    if pad:
        t = F.pad(t, (0, pad))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check(x, dy):
    if x.dim() != 4 or dy.dim() != 4 or x.shape[:3] != dy.shape[:3]:
        raise ValueError(f"x (B,H,W,Ci) and dy (B,H,W,Co) must share B, H, "
                         f"W; got {tuple(x.shape)} and {tuple(dy.shape)}")
    if x.dtype != dy.dtype or x.dtype not in _DTYPES:
        raise TypeError(f"x and dy must both be float32 or both bfloat16, "
                        f"got {x.dtype} and {dy.dtype}")
    if x.device != dy.device:
        raise ValueError("x and dy must be on one device")


def wgrad_3x3_s1(x, dy):
    """Weight gradient of a 3x3 stride-1 SAME conv, NHWC/HWIO.

    x (B, H, W, Ci) activations and dy (B, H, W, Co) output cotangent, both
    float32 or both bfloat16 -> (3, 3, Ci, Co) float32, accumulated in
    float32.  A CUDA tensor launches the kernel (and raises if the launch
    fails) on one of two routes: bfloat16 on the tensor cores, where x's and
    dy's channels are zero-padded to multiples of 8 and the result sliced
    back (``pad_channels``; the copy is part of the call's time); float32
    on the CUDA cores in full float32 (no TF32).  A CPU tensor runs
    ``wgrad_3x3_s1_reference``.  The kernel reads NHWC bytes, so a tensor
    that is not NHWC-contiguous, or on the tensor-core route not 16-byte
    aligned, is copied first.
    """
    _check(x, dy)
    if x.device.type == "cpu":
        return wgrad_3x3_s1_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_3x3_s1 runs on cuda or cpu tensors, not "
                         f"{x.device}")
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    if x.numel() == 0 or ci * co == 0:
        return torch.zeros((3, 3, ci, co), dtype=torch.float32,
                           device=x.device)
    return launch(x, dy, *plan(b, h, w, ci, co, _sms(x.device), x.dtype))


def launch(x, dy, tile: int, splits: int, chunk: int):
    """One launch of the kernel on non-empty CUDA tensors ``x`` and ``dy``
    that ``wgrad_3x3_s1`` accepts, with the split-K plan (tile, splits,
    chunk): ``wgrad_3x3_s1`` passes ``plan``'s, ``tools/wgrad_probe.py``
    sweeps others."""
    global LAUNCHES, TC_LAUNCHES
    ci, co = x.shape[-1], dy.shape[-1]
    tc = x.dtype == torch.bfloat16
    if tc:
        x, dy = pad_channels(x), pad_channels(dy)
    else:
        x, dy = x.contiguous(), dy.contiguous()
    b, h, w, cip = x.shape
    cop = dy.shape[-1]
    out = torch.empty((3, 3, cip, cop), dtype=torch.float32, device=x.device)
    ws = (torch.empty((splits, 9 * cip * cop), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    launch = _library()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), dy.data_ptr(),
                     None if ws is None else ws.data_ptr(), out.data_ptr(),
                     b, h, w, cip, cop, chunk, splits, tile, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_3x3 kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    if tc:
        TC_LAUNCHES += 1
    if (cip, cop) != (ci, co):
        out = out[:, :, :ci, :co].contiguous()
    return out


@functools.lru_cache(maxsize=None)
def _sms(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgrad_3x3_s1_reference(x, dy):
    """Plain-torch version of the kernel: nine shifted (K, Ci)^T @ (K, Co)
    products in float32 over a zero-padded x (from the same, possibly
    bfloat16-rounded, values)."""
    _check(x, dy)
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))          # (B, H+2, W+2, Ci)
    d = dy.float().reshape(-1, co)
    out = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            out[ky, kx] = xp[:, ky:ky + h, kx:kx + w].reshape(-1, ci).T @ d
    return out


class _Conv3x3S1(torch.autograd.Function):
    """y = conv(x, w), 3x3 stride 1 SAME, on NCHW tensors and OIHW w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return F.conv2d(x, w, padding=1)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # PyTorch's own data gradient (the conv transpose autograd of
            # F.conv2d runs), cast to x's dtype as the JAX backward does.
            dx = torch.ops.aten.convolution_backward(
                g, x, w, None, [1, 1], [1, 1], [1, 1], False, [0, 0], 1,
                [True, False, False])[0].to(x.dtype)
        if ctx.needs_input_grad[1]:
            # NCHW tensors in channels_last memory are NHWC bytes; the
            # kernel's HWIO result is permuted to OIHW (a view) and cast to
            # the weight's compute dtype, as dw.astype(w.dtype) does.
            dw = wgrad_3x3_s1(x.permute(0, 2, 3, 1),
                              g.permute(0, 2, 3, 1)).permute(3, 2, 0, 1)
            dw = dw.to(w.dtype)
        return dx, dw


def conv3x3_s1(x, w):
    """3x3 stride-1 SAME conv of NCHW ``x`` with OIHW ``w`` (same dtype)
    whose backward computes the weight gradient with the CUDA kernel
    (forward and data gradient stay PyTorch's).  Wired into training by
    ``YoloConfig(pallas_wgrad=True)``."""
    return _Conv3x3S1.apply(x, w)
