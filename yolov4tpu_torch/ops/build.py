"""Build the port's CUDA kernels with nvcc at first use.

Every kernel source lives in ``yolov4tpu_torch/csrc/<name>.cu`` with a plain
C interface.  ``build(name)`` compiles it into a shared library under
``build/torch_kernels/`` at the root of the checkout, keyed by a hash of the
source, the sources it includes by ``#include "..."`` and the flags so an
edit of any of them rebuilds it, and returns the library's path;
the wrappers load it with ``ctypes``; ``build_many`` builds several at
once.  nvcc's ptxas report (registers, shared memory, spills) is kept
beside the library in a ``.log`` file.

``compile_to`` is the one compile step, shared with the host code that
``yolov4tpu_torch.native`` builds with g++: each build writes a file of its
own process and moves it into place, so concurrent first builds are safe.
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source at first use and need the CUDA toolkit")


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def digest(src: Path, flags=NVCC_FLAGS) -> str:
    """Hash of ``src``, of every file beside it that it includes by
    ``#include "..."`` (recursively, each once) and of the flags."""
    h = hashlib.sha256(" ".join(flags).encode())
    seen, todo = set(), [src.resolve()]
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        text = path.read_bytes()
        h.update(text)
        for inc in _LOCAL_INCLUDE.findall(text):
            found = (path.parent / inc.decode()).resolve()
            if found.is_file():
                todo.append(found)
    return h.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` (once per ``digest``) and return the
    shared library's path.  Safe to call for several sources at once from
    threads: each build writes its own files."""
    src = CSRC / f"{name}.cu"
    so = BUILD_DIR / f"{name}-{digest(src)}.so"
    if so.exists():
        return so
    proc = compile_to(so, [nvcc(), *NVCC_FLAGS, str(src)])
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    return so


def build_many(names) -> list:
    """``build`` each of ``names`` at once, one nvcc each in a thread of
    its own; their libraries' paths in order."""
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def compile_to(so: Path, cmd, timeout=None) -> subprocess.CompletedProcess:
    """Run the compiler command ``cmd`` with ``-o`` a temporary file of this
    process, keep its output in ``so``'s ``.log`` and, if it succeeded, move
    the file to ``so`` (``os.replace``: a reader sees the whole library or
    none).  Returns the finished process."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp)], capture_output=True,
                          text=True, timeout=timeout)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode == 0:
        os.replace(tmp, so)
    else:
        tmp.unlink(missing_ok=True)
    return proc


def ptxas_report(so: Path):
    """The ptxas lines of a built library's log that give registers,
    shared memory and spills."""
    return [line.strip() for line in so.with_suffix(".log").read_text()
            .splitlines() if "registers" in line or "spill" in line]
