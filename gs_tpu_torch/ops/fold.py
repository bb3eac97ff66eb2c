"""The gradient fold: kernel K4 and its plain version.

``fold_rows(data, offsets, counts, gid)`` sums runs of entry rows
``data [E, R]`` (entry-major) into per-Gaussian rows ``[N, R]``: run i is
the rows ``[offsets[i], offsets[i] + counts[i])``, cut at the E rows there
are, and its sum goes to row ``gid[i]`` (``gid`` a permutation of
``[0, N)``). It is the contract of ``gs_tpu.ops.fold_pallas.fold_rows``
(gid-ordered runs, ``offsets`` the exclusive cumsum of ``counts``, output
``[R, N]``) with the runs in any order and scattered by ``gid``: the
render's backward hands in the raster backward's rows at each entry's
position before the tile sort, where the expansion laid each Gaussian's
entries out as one run, with the runs in depth order (``ops/binning.py::
FoldPlan``). It needs neither the JAX package's 11-operand sort by gid
(``rasterize_pallas.py:713``) nor a gather through the tile sort.

On CUDA tensors it launches ``csrc/fold.cu`` (replacing the TPU kernel
``gs_tpu/ops/fold_pallas.py::_fold_kernel``), which adds each run's rows
in entry order in float64; on CPU tensors it runs :func:`fold_rows_plain`,
the run-end differences of a float64 cumsum (``ops/segment.py``). Both
round once from float64, so they agree to float32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .segment import run_sums

MAX_ROWS = 16
SOURCE = "fold.cu"


def fold_rows_plain(data: torch.Tensor, offsets: torch.Tensor,
                    counts: torch.Tensor, gid: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the run-end differences of the rows'
    cumulative sum, scattered to the rows ``gid`` names."""
    e = data.shape[0]
    off = offsets.to(torch.int64)
    lo = off.clamp(0, e)
    hi = (off + counts.to(torch.int64)).clamp(0, e)
    sums = run_sums(data.T, lo, torch.maximum(lo, hi)).T
    out = torch.zeros_like(sums)
    out[gid.to(torch.int64)] = sums
    return out


def _check_args(data, offsets, counts, gid):
    if (data.dtype != torch.float32 or data.dim() != 2
            or not 1 <= data.shape[1] <= MAX_ROWS):
        raise ValueError(f"data must be float32 [E, 1..{MAX_ROWS}], got "
                         f"{data.dtype} {tuple(data.shape)}")
    n = offsets.shape[0]
    for name, x in (("offsets", offsets), ("counts", counts), ("gid", gid)):
        if x.dtype != torch.int32 or tuple(x.shape) != (n,):
            raise ValueError(f"{name} must be int32 [{n}], got {x.dtype} "
                             f"{tuple(x.shape)}")
        if x.device != data.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {data.device}")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.numel() >= 2 ** 31 - 16:
        raise ValueError("data too long for int32 indices")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fold_rows runs on cuda or cpu, not {data.device}")


def fold_rows(data: torch.Tensor, offsets: torch.Tensor, counts: torch.Tensor,
              gid: torch.Tensor) -> torch.Tensor:
    """[E, R] float32 entry rows, [N] int32 run offsets, counts and output
    rows (a permutation of [0, N)) -> [N, R] float32 run sums."""
    _check_args(data, offsets, counts, gid)
    if data.device.type == "cpu":
        return fold_rows_plain(data, offsets, counts, gid)
    if data.data_ptr() % 16:
        raise ValueError("data must start on a 16-byte boundary (the kernel "
                         "copies it in 16-byte pieces)")
    e, rows = data.shape
    n = offsets.shape[0]
    out = torch.empty((n, rows), dtype=torch.float32, device=data.device)
    if n == 0:
        return out
    fn = _cuda.function(SOURCE, "gs_fold_rows", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(data.data_ptr(), e, rows, offsets.data_ptr(), counts.data_ptr(),
             gid.data_ptr(), n, out.data_ptr(), data.device.index,
             _cuda.stream_ptr(data.device))
    _cuda.check(SOURCE, err, "fold_rows")
    fold_rows.launches += 1
    return out


fold_rows.launches = 0
