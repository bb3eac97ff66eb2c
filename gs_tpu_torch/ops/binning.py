"""Tile binning: duplicate Gaussians over their tile span, group by tile —
port of ``gs_tpu/ops/binning.py``.

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

A band of a multi-GPU render (``parallel/render_mc.py``) bins only the
global tile rows it owns, given as ``row_map``/``row_cumown`` (an
ascending row list and the exclusive prefix count of owned rows; the
JAX package's ``row_phase``/``row_stride`` band is the map
phase + j*stride), optionally with
``col0_map``/``col1_map`` (each local row owns only a segment of tile
columns). Coordinates stay global, tile ids are local; only the rect rows
change before K2, so K2 is the kernel of a full frame.

For a differentiable render the binning also hands back a :class:`FoldPlan`:
where the raster backward (K3) writes each sorted entry's gradient, and the
runs the gradient fold (K4, ``ops/fold.py``) sums per Gaussian, without
sorting them by gid.

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


class FoldPlan(NamedTuple):
    """Where each Gaussian's entries are, for the render's backward. Before
    the tile sort the expansion lays the entries out in depth order, each
    Gaussian's as one run. The raster backward writes the gradient of
    sorted entry e to row ``dest[e]``, its position before the sort, so
    the fold reads run i, rows ``[offsets[i], offsets[i] + counts[i])``,
    as one contiguous stream and sums it into Gaussian ``gid[i]``."""
    dest: torch.Tensor     # [capacity] int32 pre-sort position of each
    # sorted entry (the tile sort's permutation)
    offsets: torch.Tensor  # [N] int32 run start, depth order
    counts: torch.Tensor   # [N] int32 run length, depth order
    gid: torch.Tensor      # [N] int32 the Gaussian of each run: the depth
    # order, a permutation of [0, N)


def pack_bf16_pair(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Two float32 tensors -> one float32-typed tensor whose bits are the
    bf16 pair (``a`` rounded to nearest even in the low half, ``b`` in
    the high half: ``jax.lax.bitcast_convert_type``'s order on a
    little-endian host). Pure bit transport: only row movement (gathers,
    sorts) may touch the result, never arithmetic, which would flush a
    pair whose float32 reading is denormal (``b`` zero, ``a`` not)."""
    pair = torch.stack([a.to(torch.bfloat16), b.to(torch.bfloat16)], dim=-1)
    return pair.view(torch.float32).squeeze(-1)


def unpack_bf16_pair(x: torch.Tensor):
    """The inverse of :func:`pack_bf16_pair`: (low, high) as float32."""
    pair = x.unsqueeze(-1).view(torch.bfloat16)
    return pair[..., 0].to(torch.float32), pair[..., 1].to(torch.float32)


def unpack_feature_pairs(cols: torch.Tensor) -> torch.Tensor:
    """The sorted payload of ``bin_gaussians_payload(bf16_pairs=True)``,
    [8, D] (six float32 rows, then the (r, g) and (b, invdepth) pairs), ->
    the [10, D] float32 rows the raster kernels take."""
    d = cols.shape[1]
    halves = cols[6:8].contiguous().view(torch.bfloat16).reshape(2, d, 2)
    rgbd = halves.permute(0, 2, 1).reshape(4, d).to(torch.float32)
    return torch.cat([cols[:6], rgbd]).contiguous()


def tile_grid(width: int, height: int, tile_x: int, tile_y: int):
    gx = -(-width // tile_x)
    gy = -(-height // tile_y)
    return gx, gy


def quad_limit(opacity: torch.Tensor) -> torch.Tensor:
    """``two_l = 2 ln(max(255 opacity, 1))``: the value of the conic
    quadratic ``q = -2 power`` at which ``opacity * exp(-q / 2)`` falls to
    1/255. A pair with a larger q is faint."""
    return 2.0 * torch.log(torch.clamp_min(255.0 * opacity, 1.0))


def quad_min_rect(ex, ey, ca, cb, cc, x_lo, x_hi, y_lo, y_hi):
    """The minimum of ``q = ca dx^2 + 2 cb dx dy + cc dy^2`` over the
    rectangle ``[x_lo, x_hi] x [y_lo, y_hi]``, ``(dx, dy) = point - mean``
    (elementwise over broadcast tensors): 0 when the mean (ex, ey) is
    inside, else the least of the four edges' values at their clamped 1-D
    minimisers. Exact where each edge's restriction is convex (``ca``,
    ``cc`` > 0). NaN propagates. The binning's exact tile cull and the
    kernels' warp-block skip (``csrc/raster.cuh::quad_min_rect``, rounding
    for rounding) both use it."""
    ca = ca + 1e-20
    cc = cc + 1e-20
    dx0, dx1 = x_lo - ex, x_hi - ex
    dy0, dy1 = y_lo - ey, y_hi - ey

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
    return torch.where(inside, 0.0, qmin)


def band_rows(proj: Projected, radius_x, radius_y, gx: int, gy: int,
              tile_x: int, tile_y: int, row_map=None, row_cumown=None):
    """Each Gaussian's tile rect in LOCAL rows: (rx0, ry0, rx1, ry1) with
    ``ry0``/``ry1`` the first and one past the last of the rect's owned
    rows in this band's row order (``gy`` local rows). With ``row_map``
    the rect's global rows go through the owned-row prefix ``row_cumown``
    [gy_global + 1]."""
    if row_map is None:
        return tile_rect(proj.mean2d, radius_x, gx, gy, tile_x, tile_y,
                         radius_y=radius_y)
    gy_glob = row_cumown.shape[0] - 1
    rx0, gy0, rx1, gy1 = tile_rect(proj.mean2d, radius_x, gx, gy_glob,
                                   tile_x, tile_y, radius_y=radius_y)
    cum = row_cumown.to(torch.int32)
    return rx0, cum[gy0.to(torch.int64)], rx1, cum[gy1.to(torch.int64)]


def expansion_table(proj: Projected, payload: Optional[torch.Tensor],
                    width: int, height: int, tile_x: int, tile_y: int,
                    **rows):
    """Steps 1-2: the depth-ordered ``[16, N]`` float32 table for K2 (rows:
    0 offsets, 1 counts, 2 rx0, 3 ry0, 4 span width >= 1, 5 gid, 6.. the
    payload columns, zero-filled to 16), its int32 offsets, the int32
    per-gaussian counts in original order, and the int64 total. ``rows``:
    a band's row ownership, as :func:`band_rows` takes it."""
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
    rx0, ry0, rx1, ry1 = band_rows(proj, radius_x, radius_y, gx, gy,
                                   tile_x, tile_y, **rows)
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
                          capacity: int, *, exact_cull: bool = False,
                          fold_plan: bool = False, bf16_pairs: bool = False,
                          row_map=None, row_cumown=None, col0_map=None,
                          col1_map=None):
    """Binning that carries per-gaussian ``payload`` [N, F] columns through
    the expansion and the tile sort. Returns (TileBins, sorted payload
    [F, capacity] float32 rows, or None without a payload), and a
    :class:`FoldPlan` third when ``fold_plan``.

    ``row_map`` [gy_local] int (ascending global tile rows) with
    ``row_cumown`` [gy_global + 1] int (exclusive prefix count of owned
    rows): bin only this band's global tile rows (``height`` is the
    band's, local tile row j renders global row ``row_map[j]``).
    ``col0_map``/``col1_map`` [gy_local] int (with ``row_map``): local row
    j owns only global tile columns [col0_map[j], col1_map[j]); entries
    outside are culled where the exact cull culls, keeping their gid, so
    counts and offsets are unchanged and ``num_valid`` counts the
    survivors.

    ``exact_cull``: also mark expanded entries whose tile the gaussian
    cannot reach (alpha < 1/255 over the whole tile rect) invalid before the
    tile sort — they sort to the sentinel tail, shrinking every per-tile
    range while counts and offsets stay as they were. Needs the
    ``rasterize_plain.pack_projected`` packet as payload (x, y, conic a/b/c,
    opacity in columns 0-5).

    ``bf16_pairs``: the packet's colours and invdepth (columns 6-9) ride
    the tile sort as two bf16 pairs (:func:`pack_bf16_pair`), so the
    sorted payload is [8, capacity]: packed after K2's expansion, where the
    JAX package's kernel branch packs (``gs_tpu/ops/binning.py:258-266``),
    so only the sort's gather moves them (:func:`unpack_feature_pairs`
    restores the ten rows).
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
    if bf16_pairs and (payload is None or payload.shape[1] != 10):
        raise ValueError("bf16_pairs needs the 10-column packet payload")
    comb, offsets, counts0, total = expansion_table(
        proj, payload, width, height, tile_x, tile_y, row_map=row_map,
        row_cumown=row_cumown)
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
    # per-row maps are read at the entry's local row, clamped: padding
    # entries carry junk rows and are invalid already
    t_row_c = t_row.clamp(0, max(gy - 1, 0)).to(torch.int64)
    if col0_map is not None:
        # column segments of split rows: an entry outside its row's segment
        # belongs to another band's copy of the row
        valid = valid & (t_col >= col0_map.to(torch.int32)[t_row_c]) \
            & (t_col < col1_map.to(torch.int32)[t_row_c])
    if exact_cull:
        # the conic quadratic's minimum over the 1px-dilated tile rect at
        # the tile's global row; culled only on a confident miss
        g_row = t_row if row_map is None else \
            row_map.to(torch.int32)[t_row_c]
        qmin = quad_min_rect(
            out16[6], out16[7], out16[8], out16[9], out16[10],
            (t_col * tile_x - 1).to(torch.float32),
            (t_col * tile_x + tile_x).to(torch.float32),
            (g_row * tile_y - 1).to(torch.float32),
            (g_row * tile_y + tile_y).to(torch.float32))
        # relative margin absorbs the kernel's operation order; NaN
        # compares false => kept
        culled = qmin > quad_limit(out16[11]) * (1.0 + 1e-4) + 1e-3
        valid = valid & ~culled
    tile_key = torch.where(valid, tile_id, num_tiles).to(torch.int32)
    # padding entries get the sentinel gid; exact-culled ones keep theirs
    gid_e = torch.where(eidx < total, gid_e, n)

    sorted_key, perm = torch.sort(tile_key, stable=True)
    sorted_gid = gid_e[perm]
    cols = out16[6:6 + f]
    if bf16_pairs:
        cols = torch.cat([cols[:6],
                          pack_bf16_pair(cols[6], cols[7])[None],
                          pack_bf16_pair(cols[8], cols[9])[None]])
    sorted_cols = cols.index_select(1, perm) if f else None

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
    if not fold_plan:
        return bins, sorted_cols
    return bins, sorted_cols, FoldPlan(
        dest=perm.to(torch.int32), offsets=offsets,
        counts=comb[1].to(torch.int32), gid=comb[5].to(torch.int32))


def bin_gaussians(proj: Projected, width: int, height: int,
                  tile_x: int, tile_y: int, capacity: int,
                  **rows) -> TileBins:
    """The binning without a payload; ``rows``: a band's row and column
    ownership, as :func:`bin_gaussians_payload` takes it."""
    bins, _ = bin_gaussians_payload(proj, None, width, height,
                                    tile_x, tile_y, capacity, **rows)
    return bins
