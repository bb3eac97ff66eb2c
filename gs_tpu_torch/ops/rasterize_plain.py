"""Plain PyTorch rasterizers — port of ``gs_tpu/ops/rasterize_jnp.py``.

* :func:`rasterize_depthwise` — the O(N·P) oracle: every pixel walks all
  Gaussians in global depth order (with the reference's tile-rect
  visibility test). Small scenes and tests only.
* :func:`rasterize_binned` — tile-binned renderer over ``ops.binning``
  output; scans fixed-size chunks of each tile's depth-ordered entries.

Both return ``(image [3,H,W], invdepth [1,H,W], final_T [H,W])`` like the
reference rasterizer outputs (ref: gaussian_renderer/__init__.py:89-109).
"""
from __future__ import annotations

import torch

from ..core.project import Projected, tile_rect
from .binning import TileBins, tile_grid
from .composite import composite_chunk, splat_alpha


def pack_projected(proj: Projected) -> torch.Tensor:
    """[N, 10] rows (x, y, conic_a, conic_b, conic_c, opacity, r, g, b, invdepth).

    Invisible rows are zeroed entirely: culled or padded gaussians can carry
    non-finite conic and rgb, and a NaN must never reach a kernel.
    """
    safe_depth = torch.where(proj.depth > 0, proj.depth, 1.0)
    invd = 1.0 / safe_depth
    packets = torch.cat([
        proj.mean2d,
        proj.conic,
        proj.opacity[:, None],
        proj.rgb,
        invd[:, None],
    ], dim=-1)
    return torch.where(proj.visible[:, None], packets, 0.0)


def untile(x: torch.Tensor, gx: int, gy: int, tile_x: int, tile_y: int,
           width: int, height: int) -> torch.Tensor:
    """[T, C, tile_y*tile_x] per-tile pixels -> [C, H, W] image."""
    c = x.shape[1]
    x = x.reshape(gy, gx, c, tile_y, tile_x)
    x = x.permute(2, 0, 3, 1, 4).reshape(c, gy * tile_y, gx * tile_x)
    return x[:, :height, :width]


def tile_pixels(num_tiles: int, gx: int, tile_x: int, tile_y: int, device,
                row_map=None):
    """[T, P] global pixel coordinates of each tile's pixels. ``row_map``
    [T / gx]: the global tile row of each local one (a band of a
    multi-GPU render); none for a full frame."""
    pid = torch.arange(tile_x * tile_y, device=device)
    t = torch.arange(num_tiles, device=device)[:, None]
    trow = t // gx if row_map is None else row_map.to(torch.int64)[t // gx]
    px = ((t % gx) * tile_x + pid % tile_x).to(torch.float32)
    py = (trow * tile_y + pid // tile_x).to(torch.float32)
    return px, py


def rasterize_depthwise(proj: Projected, width: int, height: int,
                        bg: torch.Tensor, *, tile_x: int = 16, tile_y: int = 16,
                        chunk: int = 128):
    """O(N·P) oracle: all pixels, all Gaussians, exact reference semantics."""
    n = proj.depth.shape[0]
    dev = proj.depth.device
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    depth_key = torch.where(proj.visible, proj.depth, float("inf"))
    order = torch.argsort(depth_key, stable=True)

    packets = pack_projected(proj)[order]                      # [N, 10]
    rx0, ry0, rx1, ry1 = tile_rect(proj.mean2d[order], proj.radius[order],
                                   gx, gy, tile_x, tile_y)
    vis = proj.visible[order]

    py, px = torch.meshgrid(torch.arange(height, device=dev),
                            torch.arange(width, device=dev), indexing="ij")
    px = px.reshape(-1).to(torch.float32)
    py = py.reshape(-1).to(torch.float32)
    tcol = (px / tile_x).to(torch.int32)
    trow = (py / tile_y).to(torch.int32)
    P = width * height

    color = torch.zeros((P, 3), device=dev)
    invd = torch.zeros((P,), device=dev)
    U = torch.ones((P,), device=dev)
    Tmin = torch.ones((P,), device=dev)
    for i in range(0, n, chunk):
        pk = packets[i:i + chunk]
        alpha = splat_alpha(pk, px, py)                        # [CS, P]
        in_rect = ((rx0[i:i + chunk, None] <= tcol) & (tcol < rx1[i:i + chunk, None]) &
                   (ry0[i:i + chunk, None] <= trow) & (trow < ry1[i:i + chunk, None]))
        alpha = torch.where(in_rect & vis[i:i + chunk, None], alpha, 0.0)
        dc, dinv, U, Tmin = composite_chunk(alpha, pk[:, 6:9], pk[:, 9], U, Tmin)
        color = color + dc
        invd = invd + dinv
    img = color + Tmin[:, None] * bg[None, :]
    image = img.reshape(height, width, 3).permute(2, 0, 1)
    return image, invd.reshape(1, height, width), Tmin.reshape(height, width)


def rasterize_binned(proj: Projected, bins: TileBins, width: int, height: int,
                     bg: torch.Tensor, *, tile_x: int = 16, tile_y: int = 16,
                     max_per_tile: int = 1024, chunk: int = 64,
                     row_map=None):
    """Tile-binned renderer over the sorted duplicated entry list: each tile
    composites its first ``max_per_tile`` entries, ``chunk`` at a time.
    ``row_map`` maps local tile rows to global ones (a band of a multi-GPU
    render; ``bins`` binned with the same)."""
    gx, gy = tile_grid(width, height, tile_x, tile_y)
    T = gx * gy
    dev = proj.depth.device
    packets = pack_projected(proj)                              # [N, 10]
    cap = bins.entry_gid.shape[0]
    n_chunks = -(-max_per_tile // chunk)
    px, py = tile_pixels(T, gx, tile_x, tile_y, dev, row_map)   # [T, P]

    k = torch.arange(n_chunks * chunk, device=dev)
    pos = bins.tile_start.to(torch.int64)[:, None] + k[None, :]
    valid = (pos < bins.tile_end[:, None]) & (k < max_per_tile)
    gid = torch.where(valid, bins.entry_gid[pos.clamp(0, max(cap - 1, 0))], 0)

    P = tile_x * tile_y
    color = torch.zeros((T, P, 3), device=dev)
    invd = torch.zeros((T, P), device=dev)
    U = torch.ones((T, P), device=dev)
    Tmin = torch.ones((T, P), device=dev)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        pk = packets[gid[:, sl]]                                # [T, CS, 10]
        alpha = splat_alpha(pk, px, py)                         # [T, CS, P]
        alpha = torch.where(valid[:, sl, None], alpha, 0.0)
        dc, dinv, U, Tmin = composite_chunk(alpha, pk[..., 6:9], pk[..., 9],
                                            U, Tmin)
        color = color + dc
        invd = invd + dinv
    img = color + Tmin[:, :, None] * bg[None, None, :]          # [T, P, 3]
    out = torch.cat([img, invd[..., None], Tmin[..., None]], dim=-1)
    out = untile(out.permute(0, 2, 1), gx, gy, tile_x, tile_y, width, height)
    return out[0:3], out[3:4], out[4]
