"""Build the hand-written kernels from ``diffsensei_tpu_torch/csrc`` at first use.

CUDA sources compile with ``nvcc`` into a shared library with a plain C
interface, loaded with ``ctypes`` (no PyTorch headers, so a build takes seconds).
The library lands in ``build/kernels/`` at the root of the checkout, named by
a hash of its source and of the ``csrc`` headers it includes, so an edited
source or header is rebuilt and a stale library is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources(src: Path) -> list:
    """``src`` and every ``csrc`` header it includes by ``#include "..."``,
    transitively, each once, in the order first met."""
    seen, todo = [], [src]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [CSRC / name for name in
                 re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.M)]
    return seen


def cuda_library(source: str) -> Path:
    """Compile ``csrc/<source>`` for sm_90a (once per source hash); return the
    ``.so`` path. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside it as ``.log``."""
    src = CSRC / source
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in _sources(src))).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out

