"""Segment sums by run ends — port of ``gs_tpu/ops/segment.py::
segment_sum_runend``, the plain form of the gradient fold (K4's plain
version builds on :func:`run_sums`).

When each segment's entry count is known (the binning stage knows how many
entries each Gaussian produced), grouping the entries by segment puts each
segment's entries in one run, and a segment's sum is the difference of
the cumulative sum at its run's two ends.
"""
from __future__ import annotations

import torch


def run_sums(data: torch.Tensor, lo: torch.Tensor,
             hi: torch.Tensor) -> torch.Tensor:
    """[R, E] rows, [S] run bounds (int64, 0 <= lo <= hi <= E) -> [R, S]
    sums of each run ``[lo[s], hi[s])``: ``cum[hi] - cum[lo]`` of the
    zero-led cumulative sum, as the JAX package computes them, but with the
    cumulative sum in float64. In float32 a run's sum would carry the
    rounding of the whole prefix before it, ~6e-8 * |cum|, which at a few
    hundred thousand entries exceeds the JAX package's gradient rule
    (2e-4 of the largest gradient) for Gaussians with small sums."""
    cum = torch.cumsum(data, dim=1, dtype=torch.float64)
    cz = torch.cat([torch.zeros_like(cum[:, :1]), cum], dim=1)
    return (cz[:, hi] - cz[:, lo]).to(data.dtype)


def segment_sum_runend(value_cols, gid: torch.Tensor, counts: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum when the per-segment counts are known.

    value_cols: [D, F] tensor or a sequence of F [D] tensors.
    gid: [D] int; entries of no segment carry a sentinel >= num_segments
        (they sort past every run).
    counts: [num_segments] int, the exact number of entries per segment.
    Returns [num_segments, F].
    """
    if isinstance(value_cols, torch.Tensor):
        data = value_cols.T
    else:
        data = torch.stack(list(value_cols), dim=0)           # [F, D]
    order = torch.sort(gid.to(torch.int64), stable=True).indices
    cc = torch.cumsum(counts.to(torch.int64), dim=0)[:num_segments]
    hi = torch.clamp(cc, max=data.shape[1])
    lo = torch.cat([torch.zeros_like(hi[:1]), hi[:-1]])
    return run_sums(data[:, order], lo, hi).T
