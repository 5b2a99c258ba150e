"""3x3 stride-1 SAME convolution whose weight gradient is a hand-written
CUDA kernel.

Counterpart of ``yolov4tpu.ops.wgrad_pallas``.  ``conv3x3_s1`` is a
``torch.autograd.Function`` split as ``_conv3x3_custom`` splits its
custom_vjp: the forward is ``F.conv2d`` and the data gradient PyTorch's own
convolution backward (XLA computes both outside Pallas in the JAX package);
the weight gradient is ``wgrad_3x3_s1``, which launches
``csrc/wgrad_3x3.cu`` on CUDA tensors and runs its plain torch version,
``wgrad_3x3_s1_reference``, on CPU tensors.  Nothing else chooses between
them.  The kernel is built at first use by ``ops.build``.

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

# Launches of the CUDA kernel (one per wgrad_3x3_s1 call on the card);
# chip_smoke.py reads it to show the training path went through the kernel.
LAUNCHES = 0

# Split-K sizing: aim for this many blocks per SM over the whole grid, and
# give each split at least this many pixels.
_BLOCKS_PER_SM = 4
_MIN_CHUNK = 512
_MAX_SPLITS = 65535  # gridDim.z
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


@functools.lru_cache(maxsize=1)
def _library():
    lib = ctypes.CDLL(str(kbuild.build("wgrad_3x3")))
    fn = lib.wgrad_3x3_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(b: int, h: int, w: int, ci: int, co: int, sms: int):
    """(tile, splits, chunk) for one launch: the 128 tile where both
    channel counts reach 128, else 64; enough K splits that the grid holds
    ``_BLOCKS_PER_SM`` blocks per SM, each split at least ``_MIN_CHUNK``
    pixels (a multiple of 16, so every split starts on a K-step boundary of
    either tile)."""
    tile = 128 if ci >= 128 and co >= 128 else 64
    k = b * h * w
    tiles = -(-(9 * ci) // tile) * -(-co // tile)
    splits = max(1, min(-(-_BLOCKS_PER_SM * sms // tiles), k // _MIN_CHUNK,
                        _MAX_SPLITS))
    chunk = -(-k // splits)
    chunk = -(-chunk // 16) * 16
    return tile, -(-k // chunk), chunk


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
    float32 (float32 operands in full float32, no TF32).  A CUDA tensor
    launches the kernel (and raises if the launch fails); a CPU tensor runs
    ``wgrad_3x3_s1_reference``.  The kernel reads NHWC bytes, so a tensor
    that is not NHWC-contiguous is copied first (the copy is part of the
    call's time).
    """
    global LAUNCHES
    _check(x, dy)
    if x.device.type == "cpu":
        return wgrad_3x3_s1_reference(x, dy)
    if x.device.type != "cuda":
        raise ValueError(f"wgrad_3x3_s1 runs on cuda or cpu tensors, not "
                         f"{x.device}")
    b, h, w, ci = x.shape
    co = dy.shape[-1]
    x, dy = x.contiguous(), dy.contiguous()
    out = torch.empty((3, 3, ci, co), dtype=torch.float32, device=x.device)
    if x.numel() == 0 or out.numel() == 0:
        return out.zero_()
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    tile, splits, chunk = plan(b, h, w, ci, co, sms)
    ws = (torch.empty((splits, 9 * ci * co), dtype=torch.float32,
                      device=x.device) if splits > 1 else None)
    launch = _library()
    with torch.cuda.device(x.device):
        err = launch(x.data_ptr(), dy.data_ptr(),
                     None if ws is None else ws.data_ptr(), out.data_ptr(),
                     b, h, w, ci, co, chunk, splits, tile, _DTYPES[x.dtype],
                     torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wgrad_3x3 kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out


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
