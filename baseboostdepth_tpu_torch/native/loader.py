"""ctypes bindings for the native batch image loader, the counterpart of
`baseboostdepth_tpu/native/loader.py`.

At first use it builds `bbd_loader.cpp` (g++ -O3, linked with libjpeg; no
pybind11 needed) into `build/native/` at the root of the checkout (listed in
.gitignore), under a name keyed by a hash of the source and the command, as
`ops/cuda_build.py` keys the CUDA libraries: an edited source is rebuilt,
an unchanged one reused, and nothing is written beside the source. Without
a compiler or libjpeg, `native_available()` is False (after one line saying
why) and callers decode with PIL.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "bbd_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")

_lib = None
_lock = threading.Lock()
_build_failed = False


def _so_path() -> Path:
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode() + b"\0" + SRC.read_bytes())
    return BUILD_DIR / f"libbbd_loader_{digest.hexdigest()[:16]}.so"


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        so = _so_path()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = ["g++", *GXX_FLAGS, str(SRC), "-ljpeg", "-o", str(tmp)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(proc.stderr.strip().splitlines()[-1] if proc.stderr.strip()
                                   else f"g++ exited with {proc.returncode}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.bbd_decode_resize_batch.restype = ctypes.c_int
        lib.bbd_decode_resize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte),
        ]
        return lib
    except Exception as e:  # no g++ or no libjpeg: callers decode with PIL
        print(f"[native] loader build unavailable ({e}); using PIL fallback")
        _build_failed = True
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is None and not _build_failed:
        with _lock:
            if _lib is None and not _build_failed:
                _lib = _build()
    return _lib


def native_available() -> bool:
    return _get_lib() is not None


def decode_resize_batch(
    paths: List[str],
    width: int,
    height: int,
    threads: int = 8,
    fast: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Decode + Lanczos3-resize a batch of JPEGs.

    Returns (images uint8 [N, H, W, 3], ok bool [N]). fast=True enables
    DCT-space prescale (approximate but ~3x cheaper decode).
    """
    lib = _get_lib()
    if lib is None:
        raise RuntimeError("native loader unavailable")
    n = len(paths)
    out = np.empty((n, height, width, 3), dtype=np.uint8)
    status = np.zeros(n, dtype=np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.bbd_decode_resize_batch(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        width, height, threads, int(fast),
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
    )
    return out, status.astype(bool)
