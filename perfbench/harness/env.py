"""The run's environment: build and kernel caches at fixed paths inside
the checkout, and the check that nothing loaded JAX or the JAX package."""

from __future__ import annotations

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CACHE = ROOT / "build" / "perfbench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "yolov4tpu")


def prepare() -> None:
    """Point the kernel caches that PyTorch and Triton would use at fixed
    directories of the checkout, and keep libraries from loading JAX."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        path = CACHE / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (up to the first dot, compared
    whole) is JAX's, jaxlib's, flax's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)
                   if name.split(".")[0] in FORBIDDEN})


def tmpdir(name: str) -> Path:
    """A directory of this run's under TMPDIR, at a path fixed by name."""
    base = Path(os.environ.get("TMPDIR") or "/tmp")
    path = base / "perfbench" / name
    path.mkdir(parents=True, exist_ok=True)
    return path


def sub_seed(seed: int, stream: int) -> int:
    """The seed of one of a run's independent streams (weights, images,
    samples), a whole number below 2**63."""
    return (int(seed) * 1_000_003 + stream * 7_919) % 2 ** 63


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess
    if str(device) == "cpu":
        return "card: none (cpu)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi unavailable ({e})"
    return f"card: {out}"


def device_info(device, peak: int) -> dict:
    import torch
    if str(device) == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": peak}


def write_classes(path: Path, num_classes: int) -> Path:
    path.write_text("".join(f"class_{i}\n" for i in range(num_classes)))
    return path
