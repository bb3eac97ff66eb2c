"""Multi-GPU rendering: Gaussians sharded over a group, tile rows banded —
port of ``gs_tpu/parallel/render_mc.py``, on the tree or the packed
layout.

The phases, each over the process's local shards (``parallel/mesh.py``):

1. each shard preprocesses its Gaussians (projection, EWA, SH shading) and
   packs them into 15-column rows (the 10-float packet, then radius, depth,
   visible and the two cull half-widths); with ``visible_capacity`` it
   keeps only its visible rows, visible first, up to the cap;
2. the packets are all-gathered: every band sees every shard's rows;
3. each band bins and rasterizes its own set of global tile rows (K2, K1 or
   K1g, and in the backward K3 and K4, at the band's shapes): "stride"
   gives band d rows d, d+k, ...; "cost" deals the rows by descending
   duplicate cost in snake order, recomputed every frame; "cost" with
   ``split_rows`` H also splits the H heaviest rows by columns across all
   bands;
4. the bands are all-gathered and put back in global row order.

Gradients run the phases back: the band gather's backward hands each band
its own slice of the frame's cotangent; the packet gather's backward sums
each band's contribution into the shard that owns the packet; the visible
compaction's backward is a gather (``_CompactRows``). Every tile composites
the same entries in the same depth order as a full-frame render, so the
frame is the full frame's.

The stage stamps (``utils/spans.py``): ``preprocess`` before phase 1,
``exchange`` before each collective (the packet gather, the cost
all-reduce, the band and statistics gathers), ``binning`` where the band
assignment and the bands' binning resume; in the backward ``exchange_bwd``
where the gathered packets' gradient has arrived (the reduce-scatter
follows) and ``preprocess_bwd`` where the shards' own rows' has. Every
frame writes the gathered ``band_work`` into the ring as a counter.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.camera import Camera
from ..core.gaussians import GaussianParams
from ..core.project import (Projected, preprocess, preprocess_packed,
                            tile_rect)
from ..ops.binning import tile_grid
from ..ops.rasterize_plain import pack_projected
from ..render import RenderOutput, render_projected
from ..utils import spans

TILE = 16
BAND_ASSIGNS = ("cost", "stride")


def _rects(proj: Projected, gx: int, gy_glob: int):
    """(visible with a cull rect, rx0, gy0, rx1, gy1) over the global tile
    grid, from the opacity-aware cull half-widths."""
    rcull = (proj.radius_cull if proj.radius_cull is not None
             else torch.stack([proj.radius, proj.radius], dim=1))
    rx_ = rcull[:, 0].to(torch.int32)
    ry_ = rcull[:, 1].to(torch.int32)
    rx0, gy0, rx1, gy1 = tile_rect(proj.mean2d.detach(), rx_, gx, gy_glob,
                                   TILE, TILE, radius_y=ry_)
    return proj.visible & (rx_ > 0) & (ry_ > 0), rx0, gy0, rx1, gy1


def _span_sums(lo, hi, w, n: int):
    """out[r] = sum of w over the spans [lo, hi) that cover r, r < n, by a
    difference array: exact in int64."""
    diff = torch.zeros(n + 1, dtype=torch.int64, device=w.device)
    diff.index_add_(0, lo.to(torch.int64), w)
    diff.index_add_(0, hi.to(torch.int64), -w)
    return torch.cumsum(diff, 0)[:n]


def _row_costs(proj: Projected, gx: int, gy_glob: int):
    """Per global tile row, the duplicate cost of this shard's Gaussians:
    the summed widths of the rects that cover the row, the entries the row
    contributes to binning. int64 [gy_glob]."""
    vis, rx0, gy0, rx1, gy1 = _rects(proj, gx, gy_glob)
    w = torch.where(vis & (gy1 > gy0), (rx1 - rx0).to(torch.int64), 0)
    return _span_sums(gy0, gy1, w, gy_glob)


def _heavy_col_costs(proj: Projected, heavy, gx: int, gy_glob: int):
    """colcosts[h, c]: this shard's entries in (row heavy[h], column c).
    int64 [H, gx]."""
    vis, rx0, gy0, rx1, gy1 = _rects(proj, gx, gy_glob)
    vis = vis & (gy1 > gy0) & (rx1 > rx0)
    r = heavy.to(torch.int32)[:, None]
    w = (vis[None] & (gy0[None] <= r) & (r < gy1[None])).to(torch.int64)
    h = heavy.shape[0]
    base = (torch.arange(h, device=w.device) * (gx + 1))[:, None]
    diff = torch.zeros(h * (gx + 1), dtype=torch.int64, device=w.device)
    diff.index_add_(0, (base + rx0[None].to(torch.int64)).reshape(-1),
                    w.reshape(-1))
    diff.index_add_(0, (base + rx1[None].to(torch.int64)).reshape(-1),
                    -w.reshape(-1))
    return torch.cumsum(diff.reshape(h, gx + 1), 1)[:, :gx]


def _snake(rows, k: int, gyp: int):
    """Deal ``rows`` (in the order given, heaviest first) to k bands in
    snake order (round r goes 0..k-1 when even, k-1..0 when odd), and
    return each band's rows ascending: [k, len(rows) / k]."""
    pos = torch.arange(rows.shape[0], device=rows.device)
    rnd, rin = pos // k, pos % k
    band = torch.where(rnd % 2 == 0, rin, k - 1 - rin)
    grouped = rows[torch.argsort(band * gyp + rows)]
    return grouped.reshape(k, -1)


def _snake_row_map(cost, k: int):
    """Every band's ascending global-row list [k, gy / k]: rows by
    descending cost (ties by row), dealt in snake order (LPT-style; the
    max band stays within sum / k + the largest row cost)."""
    order = torch.argsort(-cost, stable=True)
    return _snake(order, k, cost.shape[0])


def _assign_bands_split(cost, heavy, colcosts, k: int, B: int, H: int,
                        gx: int):
    """The cost deal with the H ``heavy`` rows split by columns across ALL
    bands: the other rows are snake-dealt B to a band; heavy row h is given
    to every band d with the tile columns [qb[h, d], qb[h, d+1]) holding
    ~1/k of that row's entries (quantiles of the summed column costs).
    Returns every band's rows [k, B+H] (ascending) and column ranges
    col0/col1 [k, B+H]."""
    gyp = cost.shape[0]
    cost2 = cost.clone()
    cost2[heavy] = -1                       # heavy rows sort last
    order = torch.argsort(-cost2, stable=True)
    rows_all = _snake(order[:k * B], k, gyp)
    cums = torch.cumsum(colcosts.to(torch.float32), 1)       # [H, gx]
    total = cums[:, -1:]
    targets = (torch.arange(k, dtype=torch.float32, device=cost.device)[None]
               * total) / k
    qb = torch.searchsorted(cums.contiguous(), targets.contiguous(),
                            side="left").to(torch.int32)     # [H, k]
    qb = torch.cat([qb, torch.full((H, 1), gx, dtype=torch.int32,
                                   device=qb.device)], 1)
    rows_dev = torch.cat([rows_all, heavy[None].expand(k, H)], 1)
    c0 = torch.cat([torch.zeros((k, B), dtype=torch.int32, device=qb.device),
                    qb[:, :k].T], 1)
    c1 = torch.cat([torch.full((k, B), gx, dtype=torch.int32,
                               device=qb.device), qb[:, 1:].T], 1)
    perm = torch.argsort(rows_dev, dim=1)
    return (torch.gather(rows_dev, 1, perm), torch.gather(c0, 1, perm),
            torch.gather(c1, 1, perm))


def _cumown(row_map, gy_glob: int):
    """The exclusive prefix count of a band's owned rows, [gy_glob + 1]."""
    own = torch.zeros(gy_glob, dtype=torch.int32, device=row_map.device)
    # a fill by index: a scalar assigned through ``own[idx] = 1`` is copied
    # from the host, which a CUDA graph's capture refuses
    own.index_fill_(0, row_map.to(torch.int64), 1)
    return torch.cat([torch.zeros(1, dtype=torch.int32, device=own.device),
                      torch.cumsum(own, 0, dtype=torch.int32)])


class _CompactRows(torch.autograd.Function):
    """``x[idx]`` for the visible-first prefix ``idx`` [vcap] of a
    permutation whose inverse is ``inv`` [n]. The permutation is
    injective, so the gradient is a gather too: row r gets ct[inv[r]] if
    it was kept, else 0 (``gs_tpu/parallel/render_mc.py:180-203``)."""

    @staticmethod
    def forward(ctx, x, idx, inv):
        ctx.save_for_backward(inv)
        ctx.vcap = idx.shape[0]
        return x[idx]

    @staticmethod
    def backward(ctx, ct):
        (inv,) = ctx.saved_tensors
        ctz = torch.cat([ct, ct.new_zeros((1, ct.shape[1]))])
        return ctz[torch.clamp_max(inv, ctx.vcap)], None, None


def _shard_rows(proj: Projected):
    """[n, 15] rows: the packet, radius, depth, visible, cull rx, ry."""
    rcull = (proj.radius_cull if proj.radius_cull is not None
             else torch.stack([proj.radius, proj.radius], dim=1))
    return torch.cat([
        pack_projected(proj),
        proj.radius.to(torch.float32)[:, None],
        proj.depth[:, None],
        proj.visible.to(torch.float32)[:, None],
        rcull.to(torch.float32)], dim=1)


def _rows_projected(rows) -> Projected:
    """The gathered [N, 15] rows as the Projected a band renders."""
    return Projected(
        mean2d=rows[:, 0:2], conic=rows[:, 2:5], depth=rows[:, 11],
        radius=rows[:, 10].detach().to(torch.int32), rgb=rows[:, 6:9],
        opacity=rows[:, 5], visible=rows[:, 12].detach() > 0.5,
        radius_cull=rows[:, 13:15].detach().to(torch.int32))


def band_layout(width: int, height: int, k: int, band_assign: str = "cost",
                split_rows: int = 0):
    """(gx, gy, gy_pad, band_rows, split): the tile grid, the padded global
    row count, each band's local rows and the number of split rows."""
    if band_assign not in BAND_ASSIGNS:
        raise ValueError(f"band_assign {band_assign!r}: one of "
                         + ", ".join(BAND_ASSIGNS))
    gx, gy = tile_grid(width, height, TILE, TILE)
    split = int(split_rows) if band_assign == "cost" and k > 1 else 0
    split = min(split, max(gy - 1, 0))
    if split:
        # every band carries B dealt rows and all H heavy rows; k*B + H >= gy
        b = -(-(gy - split) // k)
        return gx, gy, k * b + split, b + split, split
    gy_pad = -(-gy // k) * k
    return gx, gy, gy_pad, gy_pad // k, 0


def band_assignment(projs, group, width: int, height: int,
                    band_assign: str = "cost", split_rows: int = 0):
    """Every band's rows as ``render_projected`` takes them: a list of k
    keyword dicts, and the source index [gy_pad, W] of the reassembly
    (position d * band_rows + j of the stacked bands for each global row
    and pixel column; None where whole rows suffice, with the row index
    [gy_pad] second). ``projs``: the local shards' projections; the costs
    are summed over the group, so every process derives the same
    assignment. Without ``split_rows`` nothing here reads the device back,
    so a CUDA graph can capture it (the training step's path); the split
    path's boolean-mask scatter synchronises with the host and is eager
    only."""
    k = group.size
    gx, gy, gy_pad, band_rows, split = band_layout(width, height, k,
                                                   band_assign, split_rows)
    dev = projs[0].depth.device
    if band_assign == "stride":
        # band d owns the global rows d, d + k, d + 2k, ...
        rows = torch.arange(gy_pad, device=dev).reshape(band_rows, k).T
    else:
        costs = [_row_costs(p, gx, gy_pad) for p in projs]
        spans.stage("exchange", dev)
        cost = group.sum(costs)
        spans.stage("binning", dev)
        rows = None if split else _snake_row_map(cost, k)
    if rows is not None:
        kws = [dict(row_map=rows[d], row_cumown=_cumown(rows[d], gy_pad))
               for d in range(k)]
        return kws, None, torch.argsort(rows.reshape(-1))
    heavy = torch.argsort(-cost, stable=True)[:split]
    colcosts = [_heavy_col_costs(p, heavy, gx, gy_pad) for p in projs]
    spans.stage("exchange", dev)
    colcosts = group.sum(colcosts)
    spans.stage("binning", dev)
    rows, c0, c1 = _assign_bands_split(cost, heavy, colcosts, k,
                                       band_rows - split, split, gx)
    kws = [dict(row_map=rows[d], row_cumown=_cumown(rows[d], gy_pad),
                col0_map=c0[d], col1_map=c1[d]) for d in range(k)]
    # each (global row, pixel column) from the one band whose copy of the
    # row owns that column: split rows have k copies with disjoint column
    # ranges, dealt rows one full-width copy
    x = torch.arange(width, device=dev)
    owns = ((x[None] >= (c0.reshape(-1) * TILE)[:, None].to(x.dtype))
            & (x[None] < (c1.reshape(-1) * TILE)[:, None].to(x.dtype)))
    src = torch.zeros((gy_pad, width), dtype=torch.int64, device=dev)
    pos = torch.arange(k * band_rows, device=dev)[:, None].expand_as(owns)
    flat = (rows.reshape(-1).to(torch.int64)[:, None] * width + x[None])
    src.view(-1)[flat[owns]] = pos[owns]
    return kws, src, None


def _reassemble(bands, band_rows: int, src, src_rows):
    """[k, C, band_rows * 16, W] bands -> [C, gy_pad * 16, W] in global
    row order: whole tile rows by ``src_rows``, or per pixel column by
    ``src``. A gather; its backward puts each band's slice back."""
    k, c, _, w = bands.shape
    g = bands.reshape(k, c, band_rows, TILE, w).permute(0, 2, 1, 3, 4)
    g = g.reshape(k * band_rows, c, TILE, w)
    if src is None:
        out = g.index_select(0, src_rows)                  # [gy_pad, C, 16, W]
    else:
        gyp = src.shape[0]
        idx = src[:, None, None, :].expand(gyp, c, TILE, w)
        out = torch.gather(g, 0, idx)
    return out.permute(1, 0, 2, 3).reshape(c, -1, w)


def render_multichip(params: GaussianParams, camera: Camera,
                     bg: torch.Tensor, group, *, active_sh_degree: int,
                     antialiasing: bool = False,
                     alive: Optional[torch.Tensor] = None,
                     mean2d_tap: Optional[torch.Tensor] = None,
                     backend: str = "auto",
                     dup_capacity: int = 1 << 18,
                     max_per_tile: int = 1024,
                     chunk: int = 64,
                     packed_sh_degree: Optional[int] = None,
                     visible_capacity: int = 0,
                     band_assign: str = "cost",
                     split_rows: int = 0,
                     exact_cull: bool = False) -> RenderOutput:
    """Render one view with the Gaussians sharded over ``group``.

    ``params``, ``alive`` and ``mean2d_tap`` (the densification gradient
    tap added to the screen-space means) are this process's local shards,
    concatenated. ``dup_capacity`` is per band. Returns the whole frame on
    every process, ``radii``/``visibility`` for the local shards, and
    ``band_duplicates``, ``band_visible`` and ``band_work`` per band.

    ``visible_capacity``: the per-shard cap on rows entering the gather
    (0: the whole shard); a shard with more visible Gaussians sets
    ``overflow``, as a binning capacity does. ``band_assign`` "cost" or
    "stride" and ``split_rows`` as ``gs_tpu/parallel/render_mc.py``.
    Without ``split_rows`` (the trainer passes none) the render reads
    nothing back to the host and a CUDA graph can capture it with its
    collectives (``train/graph.py``); with it, the band assignment is
    eager only (``band_assignment``).

    ``packed_sh_degree``: ``params`` is then the channel-major [R, C]
    block of that SH degree (``core/packed.py``), the local shards side by
    side on its column axis, and each shard's column slice goes through
    ``preprocess_packed``. The SH ramp's mask (``mask_sh_rows``) is the
    caller's, as ``mask_sh_rest`` is on the tree layout.
    """
    k, nl = group.size, len(group.local)
    cap = params.shape[1] if packed_sh_degree is not None else params.capacity
    if cap % nl:
        raise ValueError(f"{cap} local rows do not split into {nl} shards")
    n = cap // nl
    width, height = camera.width, camera.height
    _, _, gy_pad, band_rows, _ = band_layout(width, height, k, band_assign,
                                             split_rows)

    # 1. each local shard: preprocess, pack, compact
    dev = camera.device
    spans.stage("preprocess", dev)
    projs, rows, vis_over = [], [], []
    for s in range(nl):
        sl = slice(s * n, (s + 1) * n)
        kw = dict(active_sh_degree=active_sh_degree,
                  antialiasing=antialiasing,
                  alive=None if alive is None else alive[sl])
        if packed_sh_degree is not None:
            proj = preprocess_packed(params[:, sl], camera,
                                     sh_degree=packed_sh_degree, **kw)
        else:
            proj = preprocess(GaussianParams(*[t[sl] for t in params]),
                              camera, **kw)
        if mean2d_tap is not None:
            proj = proj._replace(mean2d=proj.mean2d + mean2d_tap[sl])
        r = _shard_rows(proj)
        n_vis = proj.visible.sum()
        if visible_capacity and visible_capacity < n:
            # visible first, ties in index order, so the depth sort
            # downstream meets the same sequence
            order = torch.argsort((~proj.visible).to(torch.int32),
                                  stable=True)
            r = _CompactRows.apply(r, order[:visible_capacity],
                                   torch.argsort(order))
            vis_over.append(n_vis > visible_capacity)
        else:
            vis_over.append(torch.zeros((), dtype=torch.bool,
                                        device=n_vis.device))
        projs.append(proj)
        rows.append(r)

    # 2. every shard's rows to every band; the backward's reduce-scatter
    # starts where the gathered rows' gradient has arrived, and the
    # preprocess backward where the shards' rows' gradient has
    rows = spans.mark("preprocess_bwd", *rows)
    rows = [rows] if isinstance(rows, torch.Tensor) else list(rows)
    spans.stage("exchange", dev)
    proj_all = _rows_projected(spans.mark("exchange_bwd", group.gather(rows)))

    # 3. each local band renders its rows
    spans.stage("binning", dev)
    with torch.no_grad():
        kws, src, src_rows = band_assignment(projs, group, width, height,
                                             band_assign, split_rows)
    outs = [render_projected(proj_all, width, band_rows * TILE, bg,
                             backend=backend, dup_capacity=dup_capacity,
                             max_per_tile=max_per_tile, chunk=chunk,
                             exact_cull=exact_cull, **kws[d])
            for d in group.local]

    # 4. the bands back into the frame
    spans.stage("exchange", dev)
    bands = group.gather_bands([torch.cat([o.image, o.invdepth,
                                           o.final_T[None]]) for o in outs])
    frame = _reassemble(bands, band_rows, src, src_rows)[:, :height]

    stats = group.gather_values([torch.stack([
        o.num_duplicates.to(torch.int64), o.max_tile_len.to(torch.int64),
        (o.overflow | ov).to(torch.int64), o.num_valid.to(torch.int64),
        p.visible.sum().to(torch.int64)])
        for o, ov, p in zip(outs, vis_over, projs)])        # [k, 5]
    # every band's composited entries, every rank's copy of them
    spans.count("band_work", stats[:, 3])
    return RenderOutput(
        image=frame[0:3], invdepth=frame[3:4], final_T=frame[4],
        radii=torch.cat([p.radius for p in projs]),
        visibility=torch.cat([p.visible for p in projs]),
        num_duplicates=stats[:, 0].sum().to(torch.int32),
        max_tile_len=stats[:, 1].max(),
        overflow=stats[:, 2].max() > 0,
        num_valid=stats[:, 3].sum().to(torch.int32),
        band_duplicates=stats[:, 0], band_visible=stats[:, 4],
        band_work=stats[:, 3])
