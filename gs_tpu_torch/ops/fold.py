"""The gradient fold: kernel K4 and its plain version.

``fold_rows(data, offsets, counts, index=None)`` sums per-entry rows
``data [R, D]`` into per-Gaussian rows ``[R, N]``: Gaussian g gets the
entries of its run ``[offsets[g], offsets[g] + counts[g])``, entry e read
from column ``index[e]`` when an index is given, else column e; runs are
cut at the entries there are. It is the contract of
``gs_tpu.ops.fold_pallas.fold_rows`` (whose runs are ascending with
``offsets`` the exclusive cumsum of ``counts``), with runs in any order
and the index added: the render's backward passes the inverse of the
tile sort, so it folds the raster backward's tile-ordered rows without
the JAX package's 11-operand sort by gid (``rasterize_pallas.py:713``).

On CUDA tensors it launches ``csrc/fold.cu`` (replacing the TPU kernel
``gs_tpu/ops/fold_pallas.py::_fold_kernel``); on CPU tensors it runs
:func:`fold_rows_plain`, the run-end cumsum of ``ops/segment.py``. The
kernel sums each run directly, the plain version differences a cumsum over
all entries; the two agree to float32 rounding of the cumsum.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _cuda
from .segment import run_sums

MAX_ROWS = 16
SOURCE = "fold.cu"


def fold_rows_plain(data: torch.Tensor, offsets: torch.Tensor,
                    counts: torch.Tensor,
                    index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version: gather the entries into run order, then the
    run-end differences of their cumulative sum."""
    cols = data if index is None else data[:, index.to(torch.int64)]
    e = cols.shape[1]
    off = offsets.to(torch.int64)
    lo = off.clamp(0, e)
    hi = (off + counts.to(torch.int64)).clamp(0, e)
    return run_sums(cols, lo, torch.maximum(lo, hi))


def _check_args(data, offsets, counts, index):
    if (data.dtype != torch.float32 or data.dim() != 2
            or not 1 <= data.shape[0] <= MAX_ROWS):
        raise ValueError(f"data must be float32 [1..{MAX_ROWS}, D], got "
                         f"{data.dtype} {tuple(data.shape)}")
    n = offsets.shape[0]
    named = [("offsets", offsets), ("counts", counts)]
    if index is not None:
        named.append(("index", index))
    for name, x in named:
        if x.dtype != torch.int32 or x.dim() != 1:
            raise ValueError(f"{name} must be int32 [*], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != data.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {data.device}")
    if counts.shape[0] != n:
        raise ValueError(f"counts has {counts.shape[0]} entries, offsets {n}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.shape[1] >= 2 ** 31 or n >= 2 ** 31 // MAX_ROWS:
        raise ValueError("data too long for int32 indices")


def fold_rows(data: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
              index: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[R, D] float32 entry rows, [N] int32 run offsets and counts, optional
    [E] int32 column index -> [R, N] float32 per-run sums."""
    _check_args(data, offsets, counts, index)
    if data.device.type == "cpu":
        return fold_rows_plain(data, offsets, counts, index)
    if data.device.type != "cuda":
        raise ValueError(f"fold_rows runs on cuda or cpu, not {data.device}")
    rows, d = data.shape
    n = offsets.shape[0]
    out = torch.empty((rows, n), dtype=torch.float32, device=data.device)
    if n == 0:
        return out
    fn = _cuda.function(SOURCE, "gs_fold_rows", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    err = fn(data.data_ptr(), d,
             index.data_ptr() if index is not None else None,
             index.shape[0] if index is not None else d,
             offsets.data_ptr(), counts.data_ptr(), n, rows, out.data_ptr(),
             data.device.index, _cuda.stream_ptr(data.device))
    _cuda.check(SOURCE, err, "fold_rows")
    fold_rows.launches += 1
    return out


fold_rows.launches = 0
