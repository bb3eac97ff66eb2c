"""Tile rasterizer: kernels K1 (forward, with its grad variant K1g) and K3
(backward), their plain versions, and the render pipeline around them —
port of ``gs_tpu/ops/rasterize_pallas.py``.

``raster_tiles_fwd(feats, tile_start, tile_end, gx, max_chunks)`` composites
each 16x16 tile's depth-sorted entries ``[start, min(end, base + max_chunks
* 128))`` (``base`` = start rounded down to 128, the TPU kernel's chunk
window) and returns ``[T, 5, 256]`` float32 rows (r, g, b, invdepth,
final T). On CUDA tensors it launches ``csrc/rasterize_fwd.cu`` (replacing
the TPU kernel ``gs_tpu/ops/rasterize_pallas.py::_fwd_kernel``); on CPU
tensors it runs :func:`raster_tiles_fwd_plain`, which keeps the JAX
formulation (per-chunk log1p/cumsum/exp, ``ops.composite.composite_chunk``).
The kernel's sequential product and the plain version's exp(cumsum(log1p))
differ by rounding, so a pixel whose T lands at the 1e-4 cut can flip; the
two are held to each other with the rule the JAX package uses between its
backends (``tests/test_rasterize.py::assert_images_match``).

A band of a multi-GPU render (``parallel/render_mc.py``) passes every
kernel and plain version ``row_map`` [T / gx] int32, the global tile row of
each local one (the TPU kernel's row-mapping input,
``rasterize_pallas.py:70-76``): pixel coordinates, the block skip and the
splat use the global row, and the outputs stay in local tile order. A full
frame passes none, and the kernels then run as before, bit for bit.

``raster_tiles_fwd_save`` (K1g) is the same image plus the residual the
backward needs: per pixel, one past the last entry it composited.
``raster_tiles_bwd`` (K3, ``csrc/rasterize_bwd.cu``, replacing
``_bwd_kernel``) turns the gradients of the five output rows into the
gradients of the ``[10, D]`` entry features, written entry-major as
``[D, 10]`` rows at each entry's position before the tile sort (``dest``);
its plain version :func:`raster_tiles_bwd_plain` keeps the JAX formulation
(per-chunk log1p/cumsum transmittance, the suffix sum by a reversed cumsum,
the same masks) and scatters its rows the same way.

:func:`rasterize` is the ``cuda`` render backend: pack, bin (expansion
through K2), K1 (K1g when a gradient is wanted), untile,
``image = color + T_final * bg``. Its gradient runs K3, then the fold K4
(``ops/fold.py``) back to the per-Gaussian packets, as the JAX package's
two custom VJPs do (``_raster_tiles`` and ``_bin_with_payload``), here one
``torch.autograd.Function``.

Both kernels skip work that cannot change their result: a warp works on
whole 8x4 pixel blocks of its tile and skips an entry a block cannot reach,
and a pair whose exponent is past the entry's cut is dropped before
``expf``.
:func:`block_misses`, :func:`block_cull_plain` and :func:`faint_by_power`
are those tests in PyTorch, rounding for rounding (``csrc/raster.cuh``),
for the tests and for counting what the skip removes.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import _cuda
from ..core.project import Projected
from .binning import (TileBins, bin_gaussians_payload, quad_limit,
                      quad_min_rect, tile_grid, unpack_feature_pairs)
from .composite import (ALPHA_MAX, T_EPS, alpha_from_power, composite_chunk,
                        splat_power, transmittance)
from .fold import SOURCE as FOLD_SOURCE, fold_rows
from .rasterize_plain import tile_pixels, pack_projected, untile

TILE = 16            # the kernel's tile edge (16x16 pixels, one CTA)
PIX = TILE * TILE
CS = 128             # the TPU kernel's chunk: the entry window starts at a multiple
NFEAT = 10           # x, y, conic a/b/c, opacity, r, g, b, invdepth
NOUT = 5             # r, g, b, invdepth, final T
SOURCE = "rasterize_fwd.cu"
SOURCE_BWD = "rasterize_bwd.cu"


class _Windows(NamedTuple):
    """Every tile's entry window and pixel coordinates."""
    start: torch.Tensor   # [T] int64
    base: torch.Tensor    # [T] start rounded down to CS
    limit: torch.Tensor   # [T] end of the window
    px: torch.Tensor      # [T, PIX]
    py: torch.Tensor
    n_chunks: int


def _windows(tile_start, tile_end, gx, max_chunks, dev,
             row_map=None) -> _Windows:
    num_tiles = tile_start.shape[0]
    start = tile_start.to(torch.int64)
    base = start // CS * CS
    limit = torch.minimum(tile_end.to(torch.int64), base + max_chunks * CS)
    px, py = tile_pixels(num_tiles, gx, TILE, TILE, dev, row_map)
    n_chunks = int(((limit - base + CS - 1) // CS).max()) if num_tiles else 0
    return _Windows(start, base, limit, px, py, max(n_chunks, 0))


def _chunk(feats, win: _Windows, k: int):
    """Chunk k of every tile's window: (entry index [T, CS], valid [T, CS],
    packets [T, CS, 10], power [T, CS, PIX])."""
    lane = torch.arange(CS, device=feats.device)
    idx = win.base[:, None] + k * CS + lane
    valid = (idx >= win.start[:, None]) & (idx < win.limit[:, None])
    pk = feats[:, idx.clamp(0, max(feats.shape[1] - 1, 0))].permute(1, 2, 0)
    return idx, valid, pk, splat_power(pk, win.px, win.py)


def _tile_chunks(feats, tile_start, tile_end, gx, max_chunks, row_map=None):
    """Every tile's entry window, one 128-entry chunk of every tile per
    step: yields (idx, valid, packets, power) as :func:`_chunk`."""
    win = _windows(tile_start, tile_end, gx, max_chunks, feats.device,
                   row_map)
    for k in range(win.n_chunks):
        yield _chunk(feats, win, k)


def _chunk_alpha(valid, pk, power):
    return torch.where(valid[..., None], alpha_from_power(pk, power), 0.0)


def raster_tiles_fwd_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                           tile_end: torch.Tensor, gx: int, max_chunks: int,
                           *, save: bool = False, row_map=None):
    """Plain PyTorch version of K1: every tile at once, one 128-entry chunk
    of each tile's window per step, composited as ``composite_chunk``.
    ``save``: also return K1g's residual, ``last`` [T, PIX] int32 (one past
    the last entry each pixel composits, the tile's start if none).
    ``row_map``: a band's global tile rows (module docstring)."""
    num_tiles = tile_start.shape[0]
    dev = feats.device
    color = torch.zeros((num_tiles, PIX, 3), device=dev)
    invd = torch.zeros((num_tiles, PIX), device=dev)
    U = torch.ones((num_tiles, PIX), device=dev)
    Tmin = torch.ones((num_tiles, PIX), device=dev)
    last = tile_start.to(torch.int64)[:, None].expand(num_tiles, PIX)
    for idx, valid, pk, power in _tile_chunks(feats, tile_start, tile_end, gx,
                                              max_chunks, row_map):
        alpha = _chunk_alpha(valid, pk, power)
        if save:
            _, U_after = transmittance(alpha, U)
            hit = (alpha > 0.0) & (U_after >= T_EPS)
            last = torch.maximum(last, torch.amax(
                torch.where(hit, idx[..., None] + 1, 0), dim=1))
        dc, dinv, U, Tmin = composite_chunk(alpha, pk[..., 6:9], pk[..., 9],
                                            U, Tmin)
        color = color + dc
        invd = invd + dinv
    out = torch.cat([color.permute(0, 2, 1), invd[:, None], Tmin[:, None]],
                    dim=1).contiguous()
    if save:
        return out, last.to(torch.int32).contiguous()
    return out


# FP32 operations csrc/rasterize_fwd.cu spends on one (entry, pixel) pair,
# by where the pair leaves the loop body (expf counted as one operation):
#   culled:     dx, dy (2); power (4 mul, 1 add, 1 mul, 2 mul, 1 sub);
#               power > 0 (1)                                        = 12
#   faint:      + expf, opacity * exp, fminf, alpha < 1/255 (4)       = 16
#   stopping:   + 1 - alpha, T * (1 - alpha), test_t < T_EPS (3)      = 19
#   composited: + alpha * T (1), 4 FMA (8)                            = 28
K1_OPS = {"culled": 12, "faint": 16, "stopping": 19, "composited": 28}

# FP32 operations csrc/rasterize_bwd.cu spends on one (entry, pixel) pair a
# pixel visits (those before its last composited entry), by where it
# leaves the loop body:
#   culled:     dx, dy (2); power (9); power <= 0 (1)                 = 12
#   faint:      + expf, opacity * exp, fminf, alpha >= 1/255 (4)      = 16
#   composited: + 1 - alpha, T / (1 - alpha), w (3); cdot (4 mul,
#               3 add: 7); dalpha (mul, add, div, sub: 4); S += w cdot
#               (2); 4 colour gradients (4); opg < 0.99 (1); dpower (1);
#               x and y gradients (5 each: 10); conic gradients (3
#               each: 9); opacity gradient (1); the 10 adds that fold
#               the pair into its entry's sums (10)                   = 68
K3_OPS = {"culled": 12, "faint": 16, "composited": 68}


def raster_tiles_fwd_work(feats: torch.Tensor, tile_start: torch.Tensor,
                          tile_end: torch.Tensor, gx: int,
                          max_chunks: int, row_map=None) -> dict:
    """The work K1 must do on these inputs, for its bound: the entries
    some pixel of their tile reaches (each read once), and the (entry,
    pixel) pairs each pixel reaches before it stops, by class of
    :data:`K1_OPS`. Counted from the plain version's own per-chunk
    quantities. Returns those counts and the totals ``bytes`` (entries,
    ranges and the [T, 5, 256] output, each moved once) and ``ops``."""
    num_tiles = tile_start.shape[0]
    dev = feats.device
    U = torch.ones((num_tiles, PIX), device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    n = dict(entries=zero, culled=zero, faint=zero, stopping=zero,
             composited=zero)
    for _, valid, pk, power in _tile_chunks(feats, tile_start, tile_end, gx,
                                            max_chunks, row_map):
        alpha = _chunk_alpha(valid, pk, power)
        U_before, U_after = transmittance(alpha, U)
        reached = valid[..., None] & (U_before >= T_EPS)
        culled = reached & (power > 0.0)
        hit = reached & (alpha > 0.0)
        stop = hit & (U_after < T_EPS)
        n["entries"] = n["entries"] + reached.any(-1).sum()
        n["culled"] = n["culled"] + culled.sum()
        n["faint"] = n["faint"] + (reached & ~culled & ~hit).sum()
        n["stopping"] = n["stopping"] + stop.sum()
        n["composited"] = n["composited"] + (hit & ~stop).sum()
        U = U_after[..., -1, :]
    work = {k: int(v) for k, v in n.items()}
    work["bytes"] = 4 * (work["entries"] * NFEAT + 2 * num_tiles
                         + num_tiles * NOUT * PIX
                         + (0 if row_map is None else row_map.shape[0]))
    work["ops"] = sum(K1_OPS[k] * work[k] for k in K1_OPS)
    return work


def raster_tiles_bwd_work(feats: torch.Tensor, tile_start: torch.Tensor,
                          tile_end: torch.Tensor, gx: int, max_chunks: int,
                          last: torch.Tensor, row_map=None) -> dict:
    """The work K3 must do on these inputs, for its bound: the entries in
    front of some pixel's ``last`` (each read once), and the (entry, pixel)
    pairs in front of the pixel's ``last``, by class of :data:`K3_OPS`.
    ``bytes`` counts those entries and their ``dest``, the ranges, per
    pixel the final T, its ``last`` and the five upstream gradients, and
    the [D, 10] output written once."""
    num_tiles = tile_start.shape[0]
    zero = torch.zeros((), dtype=torch.int64, device=feats.device)
    n = dict(entries=zero, culled=zero, faint=zero, composited=zero)
    lastl = last.to(torch.int64)[:, None, :]
    for idx, valid, pk, power in _tile_chunks(feats, tile_start, tile_end, gx,
                                              max_chunks, row_map):
        alpha = _chunk_alpha(valid, pk, power)
        visited = valid[..., None] & (idx[..., None] < lastl)
        culled = visited & (power > 0.0)
        hit = visited & (alpha > 0.0)
        n["entries"] = n["entries"] + visited.any(-1).sum()
        n["culled"] = n["culled"] + culled.sum()
        n["faint"] = n["faint"] + (visited & ~culled & ~hit).sum()
        n["composited"] = n["composited"] + hit.sum()
    work = {k: int(v) for k, v in n.items()}
    work["bytes"] = 4 * (work["entries"] * (NFEAT + 1) + 2 * num_tiles
                         + num_tiles * PIX * (2 + NOUT)
                         + NFEAT * feats.shape[1]
                         + (0 if row_map is None else row_map.shape[0]))
    work["ops"] = sum(K3_OPS[k] * work[k] for k in K3_OPS)
    return work


# The kernels' two conservative skips (csrc/raster.cuh), in PyTorch: a
# warp skips, for a whole 8x4 pixel block, an entry whose conic quadratic
# stays past the entry's cut over the block; a pair whose exponent is past
# the cut is dropped before expf. Both drop only pairs whose alpha is below
# 1/255 (tests/test_torch_raster_cull.py).
BLOCK_W, BLOCK_H = 8, 4
BLOCKS = PIX // (BLOCK_W * BLOCK_H)   # block b at (8 (b % 2), 4 (b // 2))


def entry_cut(opacity: torch.Tensor) -> torch.Tensor:
    """An entry's confident-miss limit on ``q = -2 power``: the binning's
    ``quad_limit`` with its margin, ``two_l (1 + 1e-4) + 1e-3``."""
    return quad_limit(opacity) * (1.0 + 1e-4) + 1e-3


def faint_by_power(power: torch.Tensor, cut: torch.Tensor) -> torch.Tensor:
    """The kernels' per-pair pre-filter: True where the pair is dropped as
    faint before its alpha is computed."""
    return -2.0 * power > cut


def block_misses(pk, x0, y0) -> torch.Tensor:
    """True where the 8x4 pixel block whose first pixel is (x0, y0) cannot
    composite the entry: q's minimum over the rectangle of the block's
    pixel centres exceeds the entry's cut by more than 1e-5 of the largest
    term q has there (which bounds the rounding of both quadratics), for a
    conic with positive diagonal. ``pk``: rows (x, y, conic a/b/c,
    opacity, ...) broadcasting against x0, y0. NaN keeps the entry."""
    ex, ey, ca, cb, cc, op = pk[0], pk[1], pk[2], pk[3], pk[4], pk[5]
    x_lo = x0.to(torch.float32)
    x_hi = (x0 + BLOCK_W - 1).to(torch.float32)
    y_lo = y0.to(torch.float32)
    y_hi = (y0 + BLOCK_H - 1).to(torch.float32)
    qmin = quad_min_rect(ex, ey, ca, cb, cc, x_lo, x_hi, y_lo, y_hi)
    mx = torch.maximum((x_lo - ex).abs(), (x_hi - ex).abs())
    my = torch.maximum((y_lo - ey).abs(), (y_hi - ey).abs())
    ab = cb.abs()
    mag = (ca.abs() + ab) * mx * mx + (cc.abs() + ab) * my * my
    return (ca > 0) & (cc > 0) & (qmin > entry_cut(op) + 1e-5 * mag)


def _block_chunks(feats, tile_start, tile_end, gx, max_chunks, row_map=None):
    """Per 128-entry chunk of every tile's window: (entry index [T, CS],
    valid [T, CS], culled [T, CS, 8]) for the tile's 8x4 blocks."""
    dev = feats.device
    win = _windows(tile_start, tile_end, gx, max_chunks, dev)
    t = torch.arange(tile_start.shape[0], device=dev)
    trow = t // gx if row_map is None else row_map.to(torch.int64)[t // gx]
    b = torch.arange(BLOCKS, device=dev)
    x0 = ((t % gx) * TILE)[:, None, None] + (b % 2) * BLOCK_W   # [T, 1, 8]
    y0 = (trow * TILE)[:, None, None] + (b // 2) * BLOCK_H
    lane = torch.arange(CS, device=dev)
    for k in range(win.n_chunks):
        idx = win.base[:, None] + k * CS + lane
        valid = (idx >= win.start[:, None]) & (idx < win.limit[:, None])
        pk = feats[:, idx.clamp(0, max(feats.shape[1] - 1, 0))]
        yield idx, valid, block_misses(pk[..., None], x0, y0)


def block_cull_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, gx: int,
                     max_chunks: int, row_map=None) -> torch.Tensor:
    """The kernels' block skip in PyTorch: [8, D] bool, True where 8x4
    block b of entry e's tile skips e (False outside every window)."""
    culled = torch.zeros((BLOCKS, feats.shape[1]), dtype=torch.bool,
                         device=feats.device)
    for idx, valid, miss in _block_chunks(feats, tile_start, tile_end, gx,
                                          max_chunks, row_map):
        culled[:, idx[valid]] = miss[valid].T
    return culled


def block_last(last: torch.Tensor) -> torch.Tensor:
    """[T, 256] per-pixel ``last`` -> [T, 8]: per 8x4 block, the largest,
    where K3 starts the block's walk back."""
    t = last.shape[0]
    return last.reshape(t, 4, BLOCK_H, 2, BLOCK_W).amax(dim=(2, 4)).reshape(t, 8)


def block_skip_counts(feats: torch.Tensor, tile_start: torch.Tensor,
                      tile_end: torch.Tensor, gx: int, max_chunks: int,
                      last: torch.Tensor = None, row_map=None) -> dict:
    """(8x4 block, entry) pairs of the windows, and how many of them the
    block skip removes: every pair for K1 (which visits them all until its
    pixels stop), or with K1g's ``last`` the pairs in front of the block's
    largest ``last``, which K3 visits."""
    zero = torch.zeros((), dtype=torch.int64, device=feats.device)
    pairs, skipped = zero, zero
    blast = None if last is None else block_last(last.to(torch.int64))
    for idx, valid, miss in _block_chunks(feats, tile_start, tile_end, gx,
                                          max_chunks, row_map):
        seen = valid[..., None].expand_as(miss)
        if blast is not None:
            seen = seen & (idx[..., None] < blast[:, None, :])
        pairs = pairs + seen.sum()
        skipped = skipped + (seen & miss).sum()
    return {"pairs": int(pairs), "skipped": int(skipped)}


def kernel_attributes(device=None) -> dict:
    """What the compiler made of K1, K1g, K3 and K4's two kernels (their
    10-row variants; "K4" the short-run kernel, "K4 long" the long-run one)
    on the card: per kernel {registers, shared_bytes (static, per CTA),
    local_bytes (spills, per thread), ctas_per_sm, threads (per CTA)}.
    Builds the kernels if needed."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    keys = ("registers", "shared_bytes", "local_bytes", "ctas_per_sm",
            "threads")
    result = {}
    for name, source, entry, lead in (
            ("K1", SOURCE, "gs_raster_tiles_fwd_attributes", [0]),
            ("K1g", SOURCE, "gs_raster_tiles_fwd_attributes", [1]),
            ("K3", SOURCE_BWD, "gs_raster_tiles_bwd_attributes", []),
            ("K4", FOLD_SOURCE, "gs_fold_rows_attributes", [0]),
            ("K4 long", FOLD_SOURCE, "gs_fold_rows_attributes", [1])):
        attrs = (ctypes.c_int * 5)()
        fn = _cuda.function(source, entry, [ctypes.c_int] * (len(lead) + 1)
                            + [ctypes.c_void_p])
        _cuda.check(source, fn(*lead, index, ctypes.addressof(attrs)), entry)
        result[name] = dict(zip(keys, list(attrs)))
    return result


def _check_args(feats, tile_start, tile_end, gx, max_chunks, row_map=None):
    if feats.dtype != torch.float32 or feats.dim() != 2 or feats.shape[0] != NFEAT:
        raise ValueError(f"feats must be float32 [{NFEAT}, D], got "
                         f"{feats.dtype} {tuple(feats.shape)}")
    t = tile_start.shape[0]
    for name, x in (("tile_start", tile_start), ("tile_end", tile_end)):
        if x.dtype != torch.int32 or tuple(x.shape) != (t,):
            raise ValueError(f"{name} must be int32 [{t}], got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != feats.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {feats.device}")
    if not feats.is_contiguous():
        raise ValueError("feats must be contiguous")
    if gx < 1 or t % gx or max_chunks < 1:
        raise ValueError(f"bad grid: {t} tiles, gx={gx}, max_chunks={max_chunks}")
    if feats.shape[1] >= 2 ** 31 // NFEAT:
        raise ValueError("feats too long for int32 entry indices")
    if feats.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the tile rasterizer runs on cuda or cpu, not "
                         f"{feats.device}")
    if row_map is not None:
        if row_map.dtype != torch.int32 or tuple(row_map.shape) != (t // gx,):
            raise ValueError(f"row_map must be int32 [{t // gx}], got "
                             f"{row_map.dtype} {tuple(row_map.shape)}")
        if row_map.device != feats.device or not row_map.is_contiguous():
            raise ValueError(f"row_map must be contiguous on {feats.device}")


def _check_tile_rows(name, x, num_tiles, rows, dtype, device):
    shape = (num_tiles, rows, PIX) if rows else (num_tiles, PIX)
    if x.dtype != dtype or tuple(x.shape) != shape:
        raise ValueError(f"{name} must be {dtype} {list(shape)}, got "
                         f"{x.dtype} {tuple(x.shape)}")
    if x.device != device or not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous on {device}")


def _ptr(x):
    """A tensor's address for a kernel argument; None (a null pointer) for
    an absent optional input."""
    return None if x is None else x.data_ptr()


def _launch_fwd(feats, tile_start, tile_end, gx, max_chunks, save, row_map):
    num_tiles = tile_start.shape[0]
    dev = feats.device
    out = torch.empty((num_tiles, NOUT, PIX), dtype=torch.float32, device=dev)
    last = (torch.empty((num_tiles, PIX), dtype=torch.int32, device=dev)
            if save else None)
    if num_tiles == 0:
        return out, last
    ptrs = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p]
    args = [feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
            tile_end.data_ptr(), num_tiles, gx, max_chunks, _ptr(row_map),
            out.data_ptr()]
    if save:
        ptrs.append(ctypes.c_void_p)
        args.append(last.data_ptr())
    name = "gs_raster_tiles_fwd_save" if save else "gs_raster_tiles_fwd"
    fn = _cuda.function(SOURCE, name, ptrs + [ctypes.c_int, ctypes.c_void_p])
    err = fn(*args, dev.index, _cuda.stream_ptr(dev))
    _cuda.check(SOURCE, err, name)
    return out, last


def raster_tiles_fwd(feats: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, gx: int, max_chunks: int, *,
                     row_map: torch.Tensor = None) -> torch.Tensor:
    """K1. [10, D] float32 sorted entry features, [T] int32 tile ranges ->
    [T, 5, 256] float32 (r, g, b, invdepth, final T per tile pixel).
    ``row_map`` [T / gx] int32: a band's global tile rows."""
    _check_args(feats, tile_start, tile_end, gx, max_chunks, row_map)
    if feats.device.type == "cpu":
        return raster_tiles_fwd_plain(feats, tile_start, tile_end, gx,
                                      max_chunks, row_map=row_map)
    out, _ = _launch_fwd(feats, tile_start, tile_end, gx, max_chunks, False,
                         row_map)
    raster_tiles_fwd.launches += 1
    return out


raster_tiles_fwd.launches = 0


def raster_tiles_fwd_save(feats: torch.Tensor, tile_start: torch.Tensor,
                          tile_end: torch.Tensor, gx: int, max_chunks: int,
                          *, row_map: torch.Tensor = None):
    """K1g, the grad variant of K1: the same [T, 5, 256] image, bitwise,
    and ``last`` [T, 256] int32, one past the last entry each pixel
    composited (the tile's start if none) — what K3 walks back from."""
    _check_args(feats, tile_start, tile_end, gx, max_chunks, row_map)
    if feats.device.type == "cpu":
        return raster_tiles_fwd_plain(feats, tile_start, tile_end, gx,
                                      max_chunks, save=True, row_map=row_map)
    out, last = _launch_fwd(feats, tile_start, tile_end, gx, max_chunks, True,
                            row_map)
    raster_tiles_fwd_save.launches += 1
    return out, last


raster_tiles_fwd_save.launches = 0


def raster_tiles_bwd_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                           tile_end: torch.Tensor, gx: int, max_chunks: int,
                           out: torch.Tensor, last: torch.Tensor,
                           dout: torch.Tensor, dest: torch.Tensor, *,
                           row_map: torch.Tensor = None) -> torch.Tensor:
    """Plain PyTorch version of K3: :func:`raster_tiles_bwd_sorted_plain`'s
    rows, row e moved to ``dest[e]``."""
    rows = raster_tiles_bwd_sorted_plain(feats, tile_start, tile_end, gx,
                                         max_chunks, out, last, dout,
                                         row_map=row_map)
    dfeats = torch.zeros_like(rows)
    dfeats[dest.to(torch.int64)] = rows
    return dfeats


def raster_tiles_bwd_sorted_plain(feats: torch.Tensor,
                                  tile_start: torch.Tensor,
                                  tile_end: torch.Tensor, gx: int,
                                  max_chunks: int, out: torch.Tensor,
                                  last: torch.Tensor,
                                  dout: torch.Tensor, *,
                                  row_map: torch.Tensor = None
                                  ) -> torch.Tensor:
    """K3's arithmetic in the JAX formulation, [D, 10] rows in the entries'
    (tile) order: a forward sweep for the transmittance entering each
    chunk, then the chunks back to front, each with its log1p/cumsum
    transmittance, the suffix sum ``S_g = sum_{h>g} w_h cdot_h`` by a
    reversed cumsum plus the carry from the chunks behind, and the TPU
    kernel's masks. Uses ``out``'s final T; ``last`` is implied by the
    masks and not read."""
    del last
    num_tiles = tile_start.shape[0]
    dev = feats.device
    win = _windows(tile_start, tile_end, gx, max_chunks, dev, row_map)
    U = torch.ones((num_tiles, PIX), device=dev)
    U_in = []
    for k in range(win.n_chunks):
        _, valid, pk, power = _chunk(feats, win, k)
        U_in.append(U)
        U = transmittance(_chunk_alpha(valid, pk, power), U)[1][:, -1]
    dC = dout[:, 0:3]                                    # [T, 3, PIX]
    dI = dout[:, 3][:, None, :]                          # [T, 1, PIX]
    dT_term = (dout[:, 4] * out[:, 4])[:, None, :]
    S = torch.zeros((num_tiles, PIX), device=dev)
    dfeats = torch.zeros((feats.shape[1], NFEAT), device=dev)
    for k in reversed(range(win.n_chunks)):
        idx, valid, pk, power = _chunk(feats, win, k)
        alpha = _chunk_alpha(valid, pk, power)
        g = torch.exp(power)
        opg = pk[..., 5:6] * g
        gate = (alpha > 0.0) & (opg < ALPHA_MAX)
        U_before, U_after = transmittance(alpha, U_in[k])
        live = U_after >= T_EPS
        w = alpha * U_before * live
        cdot = torch.einsum('tgc,tcp->tgp', pk[..., 6:9], dC) + pk[..., 9:10] * dI
        wc = w * cdot
        rc = torch.flip(torch.cumsum(torch.flip(wc, [1]), dim=1), [1])
        suffix = torch.cat([rc[:, 1:], torch.zeros_like(rc[:, :1])], dim=1)
        inv1ma = 1.0 / (1.0 - alpha)
        dalpha = (cdot * U_before * live - (suffix + S[:, None, :]) * inv1ma
                  - dT_term * inv1ma * live)
        dpower = torch.where(gate, dalpha * opg, 0.0)
        dx = pk[..., 0:1] - win.px[:, None, :]
        dy = pk[..., 1:2] - win.py[:, None, :]
        ca, cb, cc = pk[..., 2:3], pk[..., 3:4], pk[..., 4:5]
        grads = torch.stack([
            (-(ca * dx + cb * dy) * dpower).sum(-1),
            (-(cc * dy + cb * dx) * dpower).sum(-1),
            (-0.5 * dx * dx * dpower).sum(-1),
            (-dx * dy * dpower).sum(-1),
            (-0.5 * dy * dy * dpower).sum(-1),
            torch.where(gate, dalpha * g, 0.0).sum(-1),
        ], dim=-1)                                       # [T, CS, 6]
        grads = torch.cat([
            grads, torch.einsum('tgp,tcp->tgc', w, dC),
            torch.einsum('tgp,tcp->tgc', w, dI)], dim=-1)  # [T, CS, 10]
        dfeats.index_put_((idx[valid],), grads[valid], accumulate=True)
        S = S + wc.sum(1)
    return dfeats


def raster_tiles_bwd(feats: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, gx: int, max_chunks: int,
                     out: torch.Tensor, last: torch.Tensor,
                     dout: torch.Tensor, dest: torch.Tensor, *,
                     row_map: torch.Tensor = None) -> torch.Tensor:
    """K3. K1g's inputs and outputs (``out`` [T, 5, 256], ``last`` [T, 256]),
    the gradients of ``out``, ``dout`` [T, 5, 256], and ``dest`` [D] int32,
    a permutation of [0, D) -> [D, 10] float32: the gradient of entry e's
    10 features (``feats[:, e]``) in row ``dest[e]``; entries no pixel
    composited get zeros. ``row_map``: K1g's."""
    _check_args(feats, tile_start, tile_end, gx, max_chunks, row_map)
    num_tiles = tile_start.shape[0]
    for name, x, rows, dtype in (("out", out, NOUT, torch.float32),
                                 ("last", last, 0, torch.int32),
                                 ("dout", dout, NOUT, torch.float32)):
        _check_tile_rows(name, x, num_tiles, rows, dtype, feats.device)
    d = feats.shape[1]
    if dest.dtype != torch.int32 or tuple(dest.shape) != (d,):
        raise ValueError(f"dest must be int32 [{d}], got {dest.dtype} "
                         f"{tuple(dest.shape)}")
    if dest.device != feats.device or not dest.is_contiguous():
        raise ValueError(f"dest must be contiguous on {feats.device}")
    if feats.device.type == "cpu":
        return raster_tiles_bwd_plain(feats, tile_start, tile_end, gx,
                                      max_chunks, out, last, dout, dest,
                                      row_map=row_map)
    dfeats = torch.zeros((d, NFEAT), dtype=torch.float32, device=feats.device)
    if num_tiles == 0:
        return dfeats
    fn = _cuda.function(SOURCE_BWD, "gs_raster_tiles_bwd", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    err = fn(feats.data_ptr(), d, tile_start.data_ptr(),
             tile_end.data_ptr(), num_tiles, gx, max_chunks, _ptr(row_map),
             out.data_ptr(), last.data_ptr(), dout.data_ptr(),
             dest.data_ptr(), dfeats.data_ptr(), feats.device.index,
             _cuda.stream_ptr(feats.device))
    _cuda.check(SOURCE_BWD, err, "raster_tiles_bwd")
    raster_tiles_bwd.launches += 1
    return dfeats


raster_tiles_bwd.launches = 0


def max_chunks_for(max_per_tile: int) -> int:
    """Chunks of the entry window: a range of up to ``max_per_tile`` entries
    starting anywhere in a 128-aligned chunk spans at most this many (the
    TPU kernel rounds its count up to a multiple of 8 for Mosaic's layout;
    a window past the range reads nothing more)."""
    return max(-(-(max_per_tile + CS - 1) // CS), 1)


class _RasterizeBinned(torch.autograd.Function):
    """Binning with the packets carried through the tile sort, then K1g:
    ``rasterize_pallas.py::_bin_with_payload`` and ``::_raster_tiles`` in
    one function. The geometry is integer valued and passes no gradient.
    The backward runs K3, which writes each sorted entry's gradient at the
    entry's position before the tile sort, then K4, which sums each
    Gaussian's run of them back to its packet. One function, because the
    gradient of the sorted entries never exists in their sorted order,
    the shape autograd would ask of it. The packets' gradient is zero
    under capacity overflow, where the truncated entry stream no longer
    lines up with the counts."""

    @staticmethod
    def forward(ctx, packets, proj, width, height, capacity, exact_cull,
                max_chunks, rows, row_map, bf16):
        bins, feats, plan = bin_gaussians_payload(
            proj, packets, width, height, TILE, TILE, capacity,
            exact_cull=exact_cull, fold_plan=True, bf16_pairs=bf16, **rows)
        if bf16:
            feats = unpack_feature_pairs(feats)
        gx, _ = tile_grid(width, height, TILE, TILE)
        out, last = raster_tiles_fwd_save(feats, bins.tile_start,
                                          bins.tile_end, gx, max_chunks,
                                          row_map=row_map)
        ctx.save_for_backward(feats, bins.tile_start, bins.tile_end, out,
                              last, *plan, bins.overflow)
        ctx.grid = (gx, max_chunks)
        ctx.row_map = row_map
        ctx.mark_non_differentiable(*bins)
        return (*bins, out)

    @staticmethod
    def backward(ctx, *grads):
        (feats, tile_start, tile_end, out, last, dest, offsets, counts, gid,
         overflow) = ctx.saved_tensors
        d_entries = raster_tiles_bwd(feats, tile_start, tile_end, *ctx.grid,
                                     out, last, grads[-1].contiguous(), dest,
                                     row_map=ctx.row_map)
        d = fold_rows(d_entries, offsets, counts, gid)
        d_packets = torch.where(overflow, 0.0, d)
        return (d_packets,) + (None,) * 9


def kernel_row_map(row_map, device):
    """The kernels' ``row_map`` of a band: the given map as contiguous
    int32 on ``device``; None for a full frame."""
    if row_map is None:
        return None
    return row_map.to(device=device, dtype=torch.int32).contiguous()


def rasterize(proj: Projected, width: int, height: int, bg: torch.Tensor, *,
              max_per_tile: int = 4096, dup_capacity: int = 1 << 20,
              exact_cull: bool = False, bf16_features: bool = False,
              row_map=None, row_cumown=None, col0_map=None, col1_map=None):
    """Render through the kernels (16x16 tiles); differentiable with
    respect to ``proj``'s float fields and ``bg``. The ``row_*`` and
    ``col*_map`` arguments render one band of a multi-GPU frame
    (``ops/binning.py::bin_gaussians_payload``): ``height`` is then the
    band's and the images come back in its local row order.

    ``bf16_features``: the colours and invdepth ride the tile sort as bf16
    pairs and are unpacked to float32 before K1/K1g
    (``gs_tpu/ops/rasterize_pallas.py:658-677``), so every kernel sees the
    usual float32 features, quantised. The backward is straight-through:
    K3 runs on the quantised features and K4 folds as before. Geometry
    (means, conic, opacity) stays float32.

    Returns (image [3,H,W], invdepth [1,H,W], final_T [H,W],
    num_duplicates, max_tile_len, overflow, num_valid) — the last four as
    0-d device tensors, so a caller that does not read them never waits on
    the device."""
    gx, gy = tile_grid(width, height, TILE, TILE)
    max_chunks = max_chunks_for(max_per_tile)
    rows = dict(row_map=row_map, row_cumown=row_cumown, col0_map=col0_map,
                col1_map=col1_map)
    kmap = kernel_row_map(row_map, proj.depth.device)
    packets = pack_projected(proj)                       # [N, 10]
    if torch.is_grad_enabled() and packets.requires_grad:
        proj_sg = Projected(*[None if t is None else t.detach() for t in proj])
        *fields, out = _RasterizeBinned.apply(packets, proj_sg, width, height,
                                              dup_capacity, exact_cull,
                                              max_chunks, rows, kmap,
                                              bf16_features)
        bins = TileBins(*fields)
    else:
        bins, feats = bin_gaussians_payload(proj, packets, width, height,
                                            TILE, TILE, dup_capacity,
                                            exact_cull=exact_cull,
                                            bf16_pairs=bf16_features, **rows)
        if bf16_features:
            feats = unpack_feature_pairs(feats)
        out = raster_tiles_fwd(feats, bins.tile_start, bins.tile_end, gx,
                               max_chunks, row_map=kmap)
    img = out[:, 0:3] + out[:, 4:5] * bg[None, :, None]
    image = untile(img, gx, gy, TILE, TILE, width, height)
    rest = untile(out[:, 3:5], gx, gy, TILE, TILE, width, height)
    max_len = torch.max(bins.tile_end - bins.tile_start)
    overflow = bins.overflow | (max_len > max_per_tile)
    return (image, rest[0:1], rest[1], bins.num_duplicates, max_len,
            overflow, bins.num_valid)
