"""Where the tensor-core wgrad kernel's time goes, on one NVIDIA GPU.

    python -m yolov4tpu_torch.tools.wgrad_probe

Prints, beside the card's name and power limit:

- the ceiling of the kernel's inner loop: ``csrc/wgrad_probe.cu`` runs the
  128x128 block's ldmatrix + mma.sync loop (and mma.sync alone) on a
  shared-memory stage, two blocks per SM, with no copies, barriers or
  epilogue;
- for ``wgrad_3x3_s1`` in bfloat16 at b8 at each shape of the training
  path's 3x3 stride-1 convs at 416^2 (``measure.wgrad_shapes``): the
  device time of each kernel a call launches (``torch.profiler``: the
  tensor-core tiles, the split reduction, and PyTorch's copies that pad
  or slice channels), and, for split counts around the one ``plan``
  picks, the call's device time (CUDA-graph replays), its share of the
  inner loop's rate and its error against the plain version over the
  largest entry.

The per-shape times beside cuDNN's and the bound are ``chip_smoke.py``'s.
Needs CUDA; exits with status 1 without it.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ..ops import build, wgrad_cuda
from .measure import cuda_ms, graph_ms, kernel_times, wgrad_shapes

BATCH = 8
SPLIT_FACTORS = (0.25, 0.5, 0.75, 1, 1.5, 2)


def kernel_split(fn, calls: int = 10) -> str:
    """Device ms a call of ``fn`` spends in each kernel it launches."""
    parts = {}
    for key, ms in kernel_times(fn, calls).items():
        name = ("tiles" if "wgrad_tc" in key else "reduction"
                if "wgrad_reduce" in key else "copies")
        parts[name] = parts.get(name, 0.0) + ms
    return ", ".join(f"{k} {v:.4f} ms" for k, v in parts.items())


def inner_loop(sms: int, steps: int = 2000):
    """TFLOP/s of the inner loop with ldmatrix and of mma.sync alone."""
    fn = ctypes.CDLL(str(build.build("wgrad_probe"))).wgrad_probe_inner
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = 2 * sms
    out = torch.empty(blocks * 256, device="cuda")
    flop = 2.0 * blocks * 128 * 128 * 32 * steps
    rates = {}
    for name, ld in (("ldmatrix + mma.sync", 1), ("mma.sync alone", 0)):
        def run(ld=ld):
            err = fn(out.data_ptr(), blocks, steps, ld,
                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"wgrad_probe launch failed: {err}")
        rates[name] = flop / cuda_ms(run, n=1) / 1e9
    return rates


def sweep(x, dy, tile, splits, top):
    """The call's device time, share of the inner loop ``top`` (TFLOP/s)
    and relative error for split counts around ``splits``."""
    b, h, w, ci = x.shape
    k, flop = b * h * w, 2 * 9 * b * h * w * ci * dy.shape[-1]
    want = wgrad_cuda.wgrad_3x3_s1_reference(x, dy)
    chunks = {}
    for f in SPLIT_FACTORS:
        c = -(-(-(-k // max(1, int(splits * f)))) // 32) * 32
        chunks[-(-k // c)] = c
    found = []
    for s, c in sorted(chunks.items()):
        rel = float((wgrad_cuda.launch(x, dy, tile, s, c) - want).abs().max()
                    / want.abs().max())
        ms = graph_ms(lambda: wgrad_cuda.launch(x, dy, tile, s, c))
        found.append(f"{s}{'*' if s == splits else ''} {ms:.4f} ms "
                     f"({flop / ms / 1e9 / top:.1%}, err {rel:.1e})")
    return ", ".join(found)


def main() -> int:
    if not torch.cuda.is_available():
        print("wgrad_probe: CUDA is not available", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}")
    ceiling = inner_loop(sms)
    for name, rate in ceiling.items():
        print(f"inner loop, 128x128 block, 2 blocks per SM, {name}: "
              f"{rate:.1f} TFLOP/s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b = BATCH
    for (h, ci, co), n in sorted(wgrad_shapes().items(),
                                 key=lambda kv: -kv[0][0]):
        x = torch.randn((b, h, h, ci), generator=gen, device="cuda").bfloat16()
        dy = torch.randn((b, h, h, co), generator=gen,
                         device="cuda").bfloat16()
        tile, splits, chunk = wgrad_cuda.plan(b, h, h, ci, co, sms,
                                              torch.bfloat16)
        print(f"b{b} {h}x{h} {ci}->{co} x{n}: tile {tile}, {splits} splits "
              f"of {chunk} px", flush=True)
        print("  kernels: " + kernel_split(
            lambda: wgrad_cuda.wgrad_3x3_s1(x, dy)), flush=True)
        print("  splits (* the plan's; share of the inner loop, error): "
              + sweep(x, dy, tile, splits, ceiling["ldmatrix + mma.sync"]),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
