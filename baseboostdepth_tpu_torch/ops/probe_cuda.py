"""The capability probes of `tools/pallas_probe.py` as CUDA kernels
(`ops/csrc/probe.cu`), with their plain PyTorch versions.

The JAX tool's seven Pallas kernels compute four functions:
- `probe_scale`: y = 2x (`trivial`);
- `probe_gather_rows`: `jnp.take_along_axis(src, idx, axis=0)`
  (`sublane_gather`, `sublane_gather_same`);
- `probe_gather_cols`: `jnp.take_along_axis(src, idx, axis=1)`
  (`lane_gather`, `lane_gather_wide`), and on a one-row source broadcast over
  the index rows (`gather_2d_flat`, src viewed [1, H*W]);
- `probe_row_slice`: `jax.lax.dynamic_slice(src, (start, 0), (rows, C))`
  with `start` an int32 tensor on the device (`dyn_slice`).

Gathers follow `jnp.take_along_axis` on the CPU: an index in [-n, 0) wraps,
any other index outside [0, n) yields NaN. The slice start follows
`jax.lax.dynamic_slice`: a negative start counts from the end, then it is
clamped to [0, rows_src - rows].

Each wrapper launches its kernel for CUDA tensors, counting the launch in its
`launches` attribute, and runs its plain version (`*_reference`) for CPU
tensors. Nothing swaps a plain version in on a GPU.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from baseboostdepth_tpu_torch.ops.cuda_build import launch, load_library

LIB_NAME = "probe"
SOURCES = ("probe.cu",)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library(LIB_NAME, SOURCES)
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    signatures = {
        "bbd_probe_scale": [ptr, ptr, i64, ptr],
        "bbd_probe_gather_rows": [ptr, ptr, ptr, i32, i32, i32, ptr],
        "bbd_probe_gather_cols": [ptr, ptr, ptr, i32, i64, i32, i32, ptr],
        "bbd_probe_row_slice": [ptr, ptr, ptr, i32, i32, i32, ptr],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(what, **tensors):
    dev = next(iter(tensors.values())).device
    if any(t.device != dev for t in tensors.values()):
        raise ValueError(f"{what}: tensors on {[str(t.device) for t in tensors.values()]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {dev}")
    for name, t in tensors.items():
        want = torch.int32 if name in ("idx", "start") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{what}: {name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def _take_along(src: torch.Tensor, idx: torch.Tensor, dim: int) -> torch.Tensor:
    """jnp.take_along_axis on the CPU: wrap [-n, 0), NaN outside [0, n)."""
    n = src.shape[dim]
    wrapped = torch.where(idx < 0, idx.long() + n, idx.long())
    valid = (wrapped >= 0) & (wrapped < n)
    out = torch.take_along_dim(src, torch.where(valid, wrapped, 0), dim=dim)
    return torch.where(valid, out, torch.full_like(out, float("nan")))


def probe_scale_reference(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the scale kernel: x * 2."""
    return x * 2.0


def probe_gather_rows_reference(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the row gather: out[r, c] = src[idx[r, c], c]."""
    return _take_along(src, idx, 0)


def probe_gather_cols_reference(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version of the column gather: out[r, c] = src[r, idx[r, c]], a
    one-row src broadcast over idx's rows."""
    return _take_along(src, idx, 1)


def probe_row_slice_reference(src: torch.Tensor, start: torch.Tensor, rows: int = 8):
    """Plain version of the dynamic row slice: src[s : s + rows] with s from
    `start` (int32 [1]) as jax.lax.dynamic_slice places it: a negative start
    counts from the end, then s is clamped to [0, rows_src - rows]."""
    s = int(start.reshape(-1)[0])
    if s < 0:
        s += src.shape[0]
    s = min(max(s, 0), src.shape[0] - rows)
    return src.narrow(0, s, rows).clone()


def probe_scale(x: torch.Tensor) -> torch.Tensor:
    """y = 2x for float32 x of any shape.

    CUDA tensors launch the kernel (counted in `probe_scale.launches`); CPU
    tensors run the plain version."""
    _check("probe_scale", x=x)
    if x.device.type == "cpu":
        return probe_scale_reference(x)
    y = torch.empty_like(x)
    launch(_lib(), "bbd_probe_scale", (x, y), (x.numel(),))
    probe_scale.launches += 1
    return y


probe_scale.launches = 0


def probe_gather_rows(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis along rows: src float32 [n, C], idx int32 [R, C] ->
    float32 [R, C].

    CUDA tensors launch the kernel (counted in `probe_gather_rows.launches`);
    CPU tensors run the plain version."""
    _check("probe_gather_rows", src=src, idx=idx)
    if src.ndim != 2 or idx.ndim != 2 or idx.shape[1] != src.shape[1] or src.shape[0] == 0:
        raise ValueError(f"probe_gather_rows: src {tuple(src.shape)} idx {tuple(idx.shape)}")
    if src.device.type == "cpu":
        return probe_gather_rows_reference(src, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    launch(_lib(), "bbd_probe_gather_rows", (src, idx, out), (src.shape[0], *idx.shape))
    probe_gather_rows.launches += 1
    return out


probe_gather_rows.launches = 0


def probe_gather_cols(src: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """take_along_axis along columns: src float32 [R, n] (or [1, n],
    broadcast over the rows), idx int32 [R, C] -> float32 [R, C].

    CUDA tensors launch the kernel (counted in `probe_gather_cols.launches`);
    CPU tensors run the plain version."""
    _check("probe_gather_cols", src=src, idx=idx)
    if (src.ndim != 2 or idx.ndim != 2 or src.shape[0] not in (1, idx.shape[0])
            or src.shape[1] == 0):
        raise ValueError(f"probe_gather_cols: src {tuple(src.shape)} idx {tuple(idx.shape)}")
    if src.device.type == "cpu":
        return probe_gather_cols_reference(src, idx)
    out = torch.empty(idx.shape, dtype=torch.float32, device=src.device)
    row_stride = src.shape[1] if src.shape[0] == idx.shape[0] else 0
    launch(_lib(), "bbd_probe_gather_cols", (src, idx, out),
           (src.shape[1], row_stride, *idx.shape))
    probe_gather_cols.launches += 1
    return out


probe_gather_cols.launches = 0


def probe_row_slice(src: torch.Tensor, start: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """The dynamic row slice: src float32 [R, C], start int32 [1] on src's
    device (read by the kernel, so the slice stays dynamic) -> float32
    [rows, C].

    CUDA tensors launch the kernel (counted in `probe_row_slice.launches`);
    CPU tensors run the plain version."""
    _check("probe_row_slice", src=src, start=start)
    if src.ndim != 2 or start.numel() != 1 or not 0 <= rows <= src.shape[0]:
        raise ValueError(f"probe_row_slice: src {tuple(src.shape)} start "
                         f"{tuple(start.shape)} rows {rows}")
    if src.device.type == "cpu":
        return probe_row_slice_reference(src, start, rows)
    out = torch.empty((rows, src.shape[1]), dtype=torch.float32, device=src.device)
    launch(_lib(), "bbd_probe_row_slice", (src, start, out), (src.shape[0], rows, src.shape[1]))
    probe_row_slice.launches += 1
    return out


probe_row_slice.launches = 0
