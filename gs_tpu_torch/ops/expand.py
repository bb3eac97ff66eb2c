"""Duplicate expansion of the binning stage: kernel K2 and its plain version.

``expand_rows(comb, offsets, capacity)`` expands per-gaussian field rows
``[16, N]`` to per-entry rows ``[16, capacity]``: entry e carries the column
of the gaussian g with ``offsets[g] <= e < offsets[g] + counts[g]``, and
zeros past the total (counts = ``comb`` row 1). Caller contract, as for
``gs_tpu.ops.expand_pallas.expand_rows``: offsets are the exclusive cumsum
of the counts, nondecreasing, and zero-count gaussians sit last.

On CUDA tensors it launches the hand-written kernel
``csrc/expand.cu`` (replacing the TPU kernel
``gs_tpu/ops/expand_pallas.py::_expand_kernel``); on CPU tensors it runs
:func:`expand_rows_plain`. Both are bitwise equal to the TPU kernel's output.
The Pallas kernel's ``capacity % BLOCK == 0`` constraint is a TPU layout
rule and does not apply here.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

ROWS = 16
SOURCE = "expand.cu"


def expand_rows_plain(comb: torch.Tensor, offsets: torch.Tensor,
                      capacity: int) -> torch.Tensor:
    """Plain PyTorch version: repeat each column by its count, truncate at
    ``capacity``, zero-fill the rest."""
    counts = comb[1].to(torch.int64)
    owner = torch.repeat_interleave(
        torch.arange(comb.shape[1], device=comb.device), counts)[:capacity]
    out = torch.zeros((ROWS, capacity), dtype=torch.float32,
                      device=comb.device)
    out[:, :owner.shape[0]] = comb[:, owner]
    return out


def _check_args(comb, offsets, capacity):
    if comb.dtype != torch.float32 or comb.dim() != 2 or comb.shape[0] != ROWS:
        raise ValueError(f"comb must be float32 [{ROWS}, N], got "
                         f"{comb.dtype} {tuple(comb.shape)}")
    n = comb.shape[1]
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (n,):
        raise ValueError(f"offsets must be int32 [{n}], got "
                         f"{offsets.dtype} {tuple(offsets.shape)}")
    if offsets.device != comb.device:
        raise ValueError("comb and offsets must be on one device")
    if not (comb.is_contiguous() and offsets.is_contiguous()):
        raise ValueError("comb and offsets must be contiguous")
    if not 0 <= capacity < 2 ** 31 or (capacity and n >= 2 ** 31 // ROWS):
        raise ValueError(f"capacity {capacity} / N {n} out of int32 range")


def expand_rows(comb: torch.Tensor, offsets: torch.Tensor,
                capacity: int) -> torch.Tensor:
    """[16, N] float32 table, [N] int32 offsets -> [16, capacity] float32."""
    _check_args(comb, offsets, capacity)
    if comb.device.type == "cpu":
        return expand_rows_plain(comb, offsets, capacity)
    if comb.device.type != "cuda":
        raise ValueError(f"expand_rows runs on cuda or cpu, not {comb.device}")
    out = torch.empty((ROWS, capacity), dtype=torch.float32,
                      device=comb.device)
    if capacity == 0:
        return out
    fn = _cuda.function(SOURCE, "gs_expand_rows", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    err = fn(comb.data_ptr(), offsets.data_ptr(), comb.shape[1],
             out.data_ptr(), capacity, comb.device.index,
             _cuda.stream_ptr(comb.device))
    _cuda.check(SOURCE, err, "expand_rows")
    expand_rows.launches += 1
    return out


expand_rows.launches = 0
