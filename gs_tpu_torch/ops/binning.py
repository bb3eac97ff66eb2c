"""Tile binning: duplicate Gaussians over their tile span, group by tile —
port of ``gs_tpu/ops/binning.py`` (single-device path).

1. tile rects from the opacity-aware cull bbox and per-gaussian counts,
2. one stable argsort of all N by view depth, gaussians with no entries
   last (so the active prefix has strictly increasing offsets),
3. expansion of the depth-ordered ``[16, N]`` table to entries through
   kernel K2 (``ops/expand.py``),
4. optionally the exact (entry, tile) cull,
5. one stable sort by tile id — stability keeps entries depth-ordered
   within each tile, the (tile, depth) order of the reference's radix sort
   — with the payload rows riding along,
6. per-tile [start, end) ranges via searchsorted.

Integers are int32/int64 tensors throughout; the one exception is the K2
table, which keeps the JAX layout (integers as exact float32 values) so that
K2 is held bitwise against ``gs_tpu.ops.expand_pallas.expand_rows``. Every
sort is stable: depth ties break by index, as in ``jnp.argsort``. Nothing
here synchronises with the device; ``overflow`` reports a capacity the
entries did not fit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.project import Projected, tile_rect
from .expand import ROWS, expand_rows

F32_EXACT = 1 << 24   # integers ride the K2 table as exact float32 values


class TileBins(NamedTuple):
    entry_gid: torch.Tensor    # [D] int32 gaussian index per sorted entry;
    # capacity-padding entries carry the sentinel N, exact-culled entries
    # (entry_valid False) keep their real gid
    entry_valid: torch.Tensor  # [D] bool
    tile_start: torch.Tensor   # [T] int32
    tile_end: torch.Tensor     # [T] int32
    num_duplicates: torch.Tensor  # [] int32 — actual duplicates (pre-clamp)
    overflow: torch.Tensor     # [] bool — true if capacity was exceeded
    gauss_counts: torch.Tensor  # [N] int32 duplicates per gaussian,
    # original index order
    num_valid: torch.Tensor    # [] int32 entries surviving the exact cull:
    # the entries the raster kernel composites


def tile_grid(width: int, height: int, tile_x: int, tile_y: int):
    gx = -(-width // tile_x)
    gy = -(-height // tile_y)
    return gx, gy


def expansion_table(proj: Projected, payload: Optional[torch.Tensor],
                    width: int, height: int, tile_x: int, tile_y: int):
    """Steps 1-2: the depth-ordered ``[16, N]`` float32 table for K2 (rows:
    0 offsets, 1 counts, 2 rx0, 3 ry0, 4 span width >= 1, 5 gid, 6.. the
    payload columns, zero-filled to 16), its int32 offsets, the int32
    per-gaussian counts in original order, and the int64 total."""
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    n = proj.depth.shape[0]
    dev = proj.depth.device
    if proj.radius_cull is not None:
        rcull = proj.radius_cull
    else:
        rcull = torch.stack([proj.radius, proj.radius], dim=1)
    radius_x = rcull[:, 0].to(torch.int32)
    radius_y = rcull[:, 1].to(torch.int32)
    visible0 = proj.visible & (radius_x > 0) & (radius_y > 0)
    rx0, ry0, rx1, ry1 = tile_rect(proj.mean2d, radius_x, gx, gy,
                                   tile_x, tile_y, radius_y=radius_y)
    counts0 = torch.where(visible0, (rx1 - rx0) * (ry1 - ry0), 0).to(torch.int32)

    depth_key = torch.where(counts0 > 0, proj.depth, float("inf"))
    order = torch.argsort(depth_key, stable=True)
    counts = counts0[order]
    csum = torch.cumsum(counts, dim=0)                   # int64
    offsets = (csum - counts).to(torch.int32)            # exclusive
    total = csum[-1] if n else torch.zeros((), dtype=torch.int64, device=dev)

    f = payload.shape[1] if payload is not None else 0
    if f > ROWS - 6:
        raise ValueError(f"the expansion carries at most {ROWS - 6} payload "
                         f"columns, got {f}")
    comb = torch.zeros((ROWS, n), dtype=torch.float32, device=dev)
    comb[0] = offsets
    comb[1] = counts
    comb[2] = rx0[order]
    comb[3] = ry0[order]
    comb[4] = torch.clamp_min(rx1 - rx0, 1)[order]
    comb[5] = order
    if f:
        comb[6:6 + f] = payload[order].T
    return comb, offsets, counts0, total


def bin_gaussians_payload(proj: Projected, payload: Optional[torch.Tensor],
                          width: int, height: int, tile_x: int, tile_y: int,
                          capacity: int, *, exact_cull: bool = False):
    """Binning that carries per-gaussian ``payload`` [N, F] columns through
    the expansion and the tile sort. Returns (TileBins, sorted payload
    [F, capacity] float32 rows, or None without a payload).

    ``exact_cull``: also mark expanded entries whose tile the gaussian
    cannot reach (alpha < 1/255 over the whole tile rect) invalid before the
    tile sort — they sort to the sentinel tail, shrinking every per-tile
    range while counts and offsets stay as they were. Needs the
    ``rasterize_plain.pack_projected`` packet as payload (x, y, conic a/b/c,
    opacity in columns 0-5).
    """
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    num_tiles = gx * gy
    n = proj.depth.shape[0]
    dev = proj.depth.device
    if capacity >= F32_EXACT or n >= F32_EXACT:
        raise ValueError(
            f"capacity {capacity} and N {n} must stay below 2^24: offsets and "
            "gids ride the expansion table as exact float32 values")
    if exact_cull and payload is None:
        raise ValueError("exact_cull needs the packet payload")
    comb, offsets, counts0, total = expansion_table(
        proj, payload, width, height, tile_x, tile_y)
    f = payload.shape[1] if payload is not None else 0

    out16 = expand_rows(comb, offsets, capacity)         # [16, D]
    eidx = torch.arange(capacity, dtype=torch.int32, device=dev)
    off_e = out16[0].to(torch.int32)
    rx0_e = out16[2].to(torch.int32)
    ry0_e = out16[3].to(torch.int32)
    # entries past the total come out zero: clamp sw for the div/mod below;
    # `valid` sends their tile ids to the sentinel
    sw_e = torch.clamp_min(out16[4].to(torch.int32), 1)
    gid_e = out16[5].to(torch.int32)
    local = eidx - off_e
    t_col = rx0_e + local % sw_e
    t_row = ry0_e + local // sw_e
    tile_id = t_row * gx + t_col
    valid = eidx < total
    if exact_cull:
        # the conic quadratic's minimum over the 1px-dilated tile rect:
        # 0 when the mean is inside, else on an edge at the clamped 1D
        # minimizer; the tile is culled only on a confident miss
        ex, ey = out16[6], out16[7]
        ca = out16[8] + 1e-20
        cb = out16[9]
        cc = out16[10] + 1e-20
        two_l = 2.0 * torch.log(torch.clamp_min(255.0 * out16[11], 1.0))
        dx0 = (t_col * tile_x - 1).to(torch.float32) - ex
        dx1 = (t_col * tile_x + tile_x).to(torch.float32) - ex
        dy0 = (t_row * tile_y - 1).to(torch.float32) - ey
        dy1 = (t_row * tile_y + tile_y).to(torch.float32) - ey

        def q(dx, dy):
            return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

        def clip(x, lo, hi):
            return torch.minimum(torch.maximum(x, lo), hi)

        cx0 = clip(-cb * dy0 / ca, dx0, dx1)
        cx1 = clip(-cb * dy1 / ca, dx0, dx1)
        cy0 = clip(-cb * dx0 / cc, dy0, dy1)
        cy1 = clip(-cb * dx1 / cc, dy0, dy1)
        qmin = torch.minimum(torch.minimum(q(cx0, dy0), q(cx1, dy1)),
                             torch.minimum(q(dx0, cy0), q(dx1, cy1)))
        inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
        qmin = torch.where(inside, 0.0, qmin)
        # relative margin absorbs the kernel's operation order; NaN
        # compares false => kept
        culled = qmin > two_l * (1.0 + 1e-4) + 1e-3
        valid = valid & ~culled
    tile_key = torch.where(valid, tile_id, num_tiles).to(torch.int32)
    # padding entries get the sentinel gid; exact-culled ones keep theirs
    gid_e = torch.where(eidx < total, gid_e, n)

    sorted_key, perm = torch.sort(tile_key, stable=True)
    sorted_gid = gid_e[perm]
    sorted_cols = out16[6:6 + f].index_select(1, perm) if f else None

    tiles = torch.arange(num_tiles, dtype=torch.int32, device=dev)
    start = torch.searchsorted(sorted_key, tiles, out_int32=True)
    end = torch.searchsorted(sorted_key, tiles + 1, out_int32=True)
    entry_valid = sorted_key < num_tiles
    bins = TileBins(
        entry_gid=sorted_gid,
        entry_valid=entry_valid,
        tile_start=start,
        tile_end=end,
        num_duplicates=total.to(torch.int32),
        overflow=total > capacity,
        gauss_counts=counts0,
        num_valid=entry_valid.sum().to(torch.int32),
    )
    return bins, sorted_cols


def bin_gaussians(proj: Projected, width: int, height: int,
                  tile_x: int, tile_y: int, capacity: int) -> TileBins:
    bins, _ = bin_gaussians_payload(proj, None, width, height,
                                    tile_x, tile_y, capacity)
    return bins
