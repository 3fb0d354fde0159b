"""Build the port's CUDA sources at first use and load them with ctypes.

Each module's kernels are one library: one `nvcc` call over its sources,
which have a plain C interface (no PyTorch headers, so a build takes
seconds), for `sm_90a`. The shared object lands in `build/torch_ext/` at the
root of the checkout (listed in .gitignore), named by a hash of its sources,
of every shared header (`csrc/*.cuh`) and of the flags, so an edited source
or header is rebuilt and an unchanged one is reused. A failed build raises;
nothing falls back to a plain version.

FMA contraction is off (`-fmad=false`): each kernel repeats its plain
PyTorch version's float32 expressions in the same order, and without
contraction the two round alike.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_ext"
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-fmad=false",
    "-Xptxas=-v",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)
# linked into every library: bbd_cuda_error_string, for check_launch
COMMON_SOURCES = ("cuda_error.cu",)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)")
    return str(path)


def _source_paths(sources: tuple) -> list:
    return [CSRC_DIR / s for s in (*sources, *COMMON_SOURCES)]


def _lib_path(name: str, sources: tuple) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _source_paths(sources) + sorted(CSRC_DIR.glob("*.cuh")):
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


@functools.cache
def load_library(name: str, sources: tuple) -> ctypes.CDLL:
    """Compile `sources` (file names under csrc/) and COMMON_SOURCES into
    lib<name>_<hash>.so, once per content, and load it. The build log (ptxas
    register and shared-memory report included) is kept beside it as <same
    name>.log."""
    paths = _source_paths(sources)
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
    lib = ctypes.CDLL(str(so))
    lib.bbd_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bbd_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a cudaError_t other than 0."""
    if err != 0:
        msg = lib.bbd_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed: {msg} ({err})")


def launch(lib: ctypes.CDLL, fn_name: str, tensors, ints) -> None:
    """Call the launcher `fn_name` of `lib` with the tensors' data pointers,
    the integer arguments and the current stream of the tensors' device;
    raise if the launch failed."""
    dev = tensors[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, fn_name)(*(t.data_ptr() for t in tensors), *ints, stream)
    check_launch(lib, err, fn_name)


def build_log(name: str, sources: tuple) -> str:
    """The compiler output kept from building `name` (loads it first)."""
    load_library(name, sources)
    log = _lib_path(name, sources).with_suffix(".log")
    return log.read_text() if log.exists() else ""
