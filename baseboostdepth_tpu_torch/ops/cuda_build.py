"""Build the port's CUDA sources at first use and load them with ctypes.

Each library is one `nvcc` call over sources with a plain C interface (no
PyTorch headers, so a build takes seconds) for `sm_90a`. The
shared object lands in `build/torch_ext/` at the root of the checkout (listed
in .gitignore), named by a hash of its sources and flags, so an edited source
is rebuilt and an unchanged one is reused. A failed build raises; nothing
falls back to a plain version.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")
    return str(path)


def _lib_path(name: str, sources: tuple) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources:
        digest.update((CSRC_DIR / s).read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) into lib<name>_<hash>.so,
    once per content, and load it. The build log (ptxas register and
    shared-memory report included) is kept beside it as <same name>.log."""
    paths = [CSRC_DIR / s for s in sources]
    so = _lib_path(name, sources)
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, paths)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        so.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}:\n{proc.stderr}")
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def build_log(name: str, sources: tuple) -> str:
    """The compiler output kept from building `name` (loads it first)."""
    load_library(name, sources)
    log = _lib_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""
