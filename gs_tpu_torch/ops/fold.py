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
(``rasterize_pallas.py:713``) nor a gather through the tile sort. Runs may
also overlap, leave gaps, be empty, start below 0 or pass the end.

On CUDA tensors it launches ``csrc/fold.cu`` (replacing the TPU kernel
``gs_tpu/ops/fold_pallas.py::_fold_kernel``): a short kernel in which one
thread adds a run of at most ``SHORT_RUN_ROWS`` rows, and a long kernel in
which one warp adds each ``PIECE_ROWS``-row piece of a longer run (a splat
that covers the screen is thousands of rows), the run's pieces then added
in piece order by the warp that finishes its last. The wrapper allocates
the pieces' scratch with ``torch.empty``, sized from N, E and R alone
(:func:`piece_slots`), so nothing is read back; the kernel counts one
launch per call. Every sum is taken in float64 in a fixed order and
rounded once, whichever warp adds which piece, so the result is the same
bits from run to run. On CPU tensors it runs :func:`fold_rows_plain`, the
run-end differences of a float64 cumsum (``ops/segment.py``). Both round
once from float64, so they agree to float32 rounding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from .segment import run_sums

MAX_ROWS = 16
SOURCE = "fold.cu"
SHORT_RUN_ROWS = 256   # runs of up to this many rows: one thread each
PIECE_ROWS = 256       # a longer run's pieces: one warp each


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


def piece_slots(n_entries: int, short_run_rows: int = SHORT_RUN_ROWS,
                piece_rows: int = PIECE_ROWS) -> int:
    """Piece slots of the long kernel's scratch: enough for every piece of
    runs that do not overlap (each long run has more than
    ``short_run_rows`` rows of the ``n_entries``, and adds at most one
    ragged piece). Overlapping runs whose claims do not fit are summed
    piece after piece by one warp each, to the same bits."""
    return (-(-n_entries // piece_rows) + n_entries // (short_run_rows + 1)
            + 1)


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
    cap = piece_slots(e, SHORT_RUN_ROWS, PIECE_ROWS)
    # a 16-byte header, float64 partials [cap, R], int32 [2 N + 2 cap]
    scratch = torch.empty(16 + 8 * cap * rows + 4 * (2 * n + 2 * cap),
                          dtype=torch.uint8, device=data.device)
    fn = _cuda.function(SOURCE, "gs_fold_rows", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(data.data_ptr(), e, rows, offsets.data_ptr(), counts.data_ptr(),
             gid.data_ptr(), n, SHORT_RUN_ROWS, PIECE_ROWS, cap,
             scratch.data_ptr(), out.data_ptr(), data.device.index,
             _cuda.stream_ptr(data.device))
    _cuda.check(SOURCE, err, "fold_rows")
    fold_rows.launches += 1
    return out


fold_rows.launches = 0
