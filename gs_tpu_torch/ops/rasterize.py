"""Forward tile rasterizer: kernel K1, its plain version, and the no-grad
render pipeline around it — port of the forward half of
``gs_tpu/ops/rasterize_pallas.py``.

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

:func:`rasterize` is the ``cuda`` render backend: pack, bin (expansion
through K2), K1, untile, ``image = color + T_final * bg``.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda
from ..core.project import Projected
from .binning import bin_gaussians_payload, tile_grid
from .composite import (T_EPS, alpha_from_power, composite_chunk,
                        splat_power, transmittance)
from .rasterize_plain import tile_pixels, pack_projected, untile

TILE = 16            # the kernel's tile edge (16x16 pixels, one CTA)
PIX = TILE * TILE
CS = 128             # the TPU kernel's chunk: the entry window starts at a multiple
NFEAT = 10           # x, y, conic a/b/c, opacity, r, g, b, invdepth
NOUT = 5             # r, g, b, invdepth, final T
SOURCE = "rasterize_fwd.cu"


def _tile_chunks(feats, tile_start, tile_end, gx, max_chunks):
    """Every tile's entry window, one 128-entry chunk of every tile per
    step: yields (valid [T, CS], packets [T, CS, 10], power [T, CS, PIX])."""
    num_tiles = tile_start.shape[0]
    d = feats.shape[1]
    dev = feats.device
    start = tile_start.to(torch.int64)
    end = tile_end.to(torch.int64)
    base = start // CS * CS
    limit = torch.minimum(end, base + max_chunks * CS)
    px, py = tile_pixels(num_tiles, gx, TILE, TILE, dev)       # [T, PIX]
    n_chunks = int(((limit - base + CS - 1) // CS).max()) if num_tiles else 0
    lane = torch.arange(CS, device=dev)
    for k in range(max(n_chunks, 0)):
        idx = base[:, None] + k * CS + lane                     # [T, CS]
        valid = (idx >= start[:, None]) & (idx < limit[:, None])
        pk = feats[:, idx.clamp(0, max(d - 1, 0))].permute(1, 2, 0)  # [T, CS, 10]
        yield valid, pk, splat_power(pk, px, py)


def raster_tiles_fwd_plain(feats: torch.Tensor, tile_start: torch.Tensor,
                           tile_end: torch.Tensor, gx: int,
                           max_chunks: int) -> torch.Tensor:
    """Plain PyTorch version of K1: every tile at once, one 128-entry chunk
    of each tile's window per step, composited as ``composite_chunk``."""
    num_tiles = tile_start.shape[0]
    dev = feats.device
    color = torch.zeros((num_tiles, PIX, 3), device=dev)
    invd = torch.zeros((num_tiles, PIX), device=dev)
    U = torch.ones((num_tiles, PIX), device=dev)
    Tmin = torch.ones((num_tiles, PIX), device=dev)
    for valid, pk, power in _tile_chunks(feats, tile_start, tile_end, gx,
                                         max_chunks):
        alpha = torch.where(valid[..., None], alpha_from_power(pk, power), 0.0)
        dc, dinv, U, Tmin = composite_chunk(alpha, pk[..., 6:9], pk[..., 9],
                                            U, Tmin)
        color = color + dc
        invd = invd + dinv
    return torch.cat([color.permute(0, 2, 1), invd[:, None], Tmin[:, None]],
                     dim=1).contiguous()


# FP32 operations csrc/rasterize_fwd.cu spends on one (entry, pixel) pair,
# by where the pair leaves the loop body (expf counted as one operation):
#   culled:     dx, dy (2); power (4 mul, 1 add, 1 mul, 2 mul, 1 sub);
#               power > 0 (1)                                        = 12
#   faint:      + expf, opacity * exp, fminf, alpha < 1/255 (4)       = 16
#   stopping:   + 1 - alpha, T * (1 - alpha), test_t < T_EPS (3)      = 19
#   composited: + alpha * T (1), 4 FMA (8)                            = 28
K1_OPS = {"culled": 12, "faint": 16, "stopping": 19, "composited": 28}


def raster_tiles_fwd_work(feats: torch.Tensor, tile_start: torch.Tensor,
                          tile_end: torch.Tensor, gx: int,
                          max_chunks: int) -> dict:
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
    for valid, pk, power in _tile_chunks(feats, tile_start, tile_end, gx,
                                         max_chunks):
        alpha = torch.where(valid[..., None], alpha_from_power(pk, power), 0.0)
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
                         + num_tiles * NOUT * PIX)
    work["ops"] = sum(K1_OPS[k] * work[k] for k in K1_OPS)
    return work


def _check_args(feats, tile_start, tile_end, gx, max_chunks):
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


def raster_tiles_fwd(feats: torch.Tensor, tile_start: torch.Tensor,
                     tile_end: torch.Tensor, gx: int,
                     max_chunks: int) -> torch.Tensor:
    """[10, D] float32 sorted entry features, [T] int32 tile ranges ->
    [T, 5, 256] float32 (r, g, b, invdepth, final T per tile pixel)."""
    _check_args(feats, tile_start, tile_end, gx, max_chunks)
    if feats.device.type == "cpu":
        return raster_tiles_fwd_plain(feats, tile_start, tile_end, gx,
                                      max_chunks)
    if feats.device.type != "cuda":
        raise ValueError(f"raster_tiles_fwd runs on cuda or cpu, not {feats.device}")
    num_tiles = tile_start.shape[0]
    out = torch.empty((num_tiles, NOUT, PIX), dtype=torch.float32,
                      device=feats.device)
    if num_tiles == 0:
        return out
    fn = _cuda.function(SOURCE, "gs_raster_tiles_fwd", [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_void_p])
    err = fn(feats.data_ptr(), feats.shape[1], tile_start.data_ptr(),
             tile_end.data_ptr(), num_tiles, gx, max_chunks, out.data_ptr(),
             feats.device.index, _cuda.stream_ptr(feats.device))
    _cuda.check(SOURCE, err, "raster_tiles_fwd")
    raster_tiles_fwd.launches += 1
    return out


raster_tiles_fwd.launches = 0


def max_chunks_for(max_per_tile: int) -> int:
    """Chunks of the entry window: a range of up to ``max_per_tile`` entries
    starting anywhere in a 128-aligned chunk spans at most this many (the
    TPU kernel rounds its count up to a multiple of 8 for Mosaic's layout;
    a window past the range reads nothing more)."""
    return max(-(-(max_per_tile + CS - 1) // CS), 1)


def rasterize(proj: Projected, width: int, height: int, bg: torch.Tensor, *,
              max_per_tile: int = 4096, dup_capacity: int = 1 << 20,
              exact_cull: bool = False):
    """No-grad render through the kernels (16x16 tiles).

    Returns (image [3,H,W], invdepth [1,H,W], final_T [H,W],
    num_duplicates, max_tile_len, overflow, num_valid) — the last four as
    0-d device tensors, so a caller that does not read them never waits on
    the device."""
    gx, gy = tile_grid(width, height, TILE, TILE)
    packets = pack_projected(proj)                       # [N, 10]
    bins, feats = bin_gaussians_payload(proj, packets, width, height,
                                        TILE, TILE, dup_capacity,
                                        exact_cull=exact_cull)
    out = raster_tiles_fwd(feats, bins.tile_start, bins.tile_end, gx,
                           max_chunks_for(max_per_tile))
    img = out[:, 0:3] + out[:, 4:5] * bg[None, :, None]
    image = untile(img, gx, gy, TILE, TILE, width, height)
    rest = untile(out[:, 3:5], gx, gy, TILE, TILE, width, height)
    max_len = torch.max(bins.tile_end - bins.tile_start)
    overflow = bins.overflow | (max_len > max_per_tile)
    return (image, rest[0:1], rest[1], bins.num_duplicates, max_len,
            overflow, bins.num_valid)
