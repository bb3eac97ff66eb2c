"""The work a frame or an iteration needs, counted from its inputs: the
yardstick of the rooflines and of ``train_mfu``/``view_mfu``.

Frozen copies of the program's work arithmetic at the time the benchmark
was written (``gs_tpu_torch/ops/rasterize.py::raster_tiles_fwd_work`` and
``raster_tiles_bwd_work`` with their ``K1_OPS``/``K3_OPS``), applied to the
benchmark's own projection and binning (``reference/render.py``), never
to the program's: a later change to the program cannot change what is
counted. The per-Gaussian and per-pixel operation counts of the
preprocess, SSIM and Adam are counted from their published formulas,
below. Only what the inputs need is counted: alive Gaussians, the
(entry, pixel) pairs a pixel reaches before it stops.
"""
from __future__ import annotations

import torch

from ..reference import render as R

# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32 = 67e12
HBM_BYTES_PER_S = 3.35e12

TILE = 16
PIX = TILE * TILE
CS = 128
NFEAT = 10
NOUT = 5

# FP32 operations the forward rasterizer spends on one (entry, pixel)
# pair, by where the pair leaves the loop body (expf counted as one):
#   culled:     dx, dy (2); power (9); power > 0 (1)                  = 12
#   faint:      + expf, opacity * exp, fminf, alpha < 1/255 (4)       = 16
#   stopping:   + 1 - alpha, T * (1 - alpha), test_t < 1e-4 (3)       = 19
#   composited: + alpha * T (1), 4 FMA (8)                            = 28
K1_OPS = {"culled": 12, "faint": 16, "stopping": 19, "composited": 28}
# the backward rasterizer, per pair a pixel visits (in front of its last):
#   culled 12, faint 16 as above; composited: + 1 - alpha, T / (1 - alpha),
#   w (3); colour dot (7); d alpha (4); S += w cdot (2); 4 colour
#   gradients (4); the clamp test (1); d power (1); x, y gradients (10);
#   conic gradients (9); opacity gradient (1); 10 adds into the entry's
#   sums (10)                                                         = 68
K3_OPS = {"culled": 12, "faint": 16, "composited": 68}

# the per-Gaussian preprocess forward (reference/render.py::project):
# view transform 18, pixel coordinates 12, quaternion to rotation and the
# 3D covariance 90, the Jacobian, J W Sigma W^T J^T, low-pass, conic and
# radius 110, SH degree 3 with the direction and clamp 145, sigmoid 4
PREPROCESS_OPS = 380
# a backward pass costs about twice its forward
BACKWARD_FACTOR = 2
# per pixel and channel: SSIM's five maps and their two 11-tap blurs
# (220) and the SSIM formula (25); L1 (3)
SSIM_OPS = 245
L1_OPS = 3
# Adam per element: m (3), v (4), the bias-corrected update (7)
ADAM_OPS = 14
# the gradient fold: one add per feature of each entry
FOLD_OPS_PER_ENTRY = NFEAT


def _alpha(pk, power):
    op = pk[..., 5:6]
    alpha = torch.clamp_max(op * torch.exp(power), 0.99)
    alpha = torch.where(power > 0.0, 0.0, alpha)
    return torch.where(alpha < 1.0 / 255.0, 0.0, alpha)


def _power(pk, px, py):
    dx = pk[..., :, 0:1] - px[..., None, :]
    dy = pk[..., :, 1:2] - py[..., None, :]
    return (-0.5 * (pk[..., :, 2:3] * dx * dx + pk[..., :, 4:5] * dy * dy)
            - pk[..., :, 3:4] * dx * dy)


def _transmittance(alpha, carry):
    lg = torch.log1p(-alpha)
    cum = torch.cumsum(lg, dim=-2)
    return carry[..., None, :] * torch.exp(cum - lg), \
        carry[..., None, :] * torch.exp(cum)


def _chunks(feats, tile_start, tile_end, gx):
    """Every tile's entry window in 128-entry chunks (windows start at a
    multiple of 128): (entry index [T, CS], valid [T, CS], packets
    [T, CS, 10], power [T, CS, PIX])."""
    dev = feats.device
    num_tiles = tile_start.shape[0]
    start = tile_start.to(torch.int64)
    base = start // CS * CS
    limit = tile_end.to(torch.int64)
    pid = torch.arange(PIX, device=dev)
    t = torch.arange(num_tiles, device=dev)[:, None]
    px = ((t % gx) * TILE + pid % TILE).to(torch.float32)
    py = ((t // gx) * TILE + pid // TILE).to(torch.float32)
    n = int(((limit - base + CS - 1) // CS).max()) if num_tiles else 0
    lane = torch.arange(CS, device=dev)
    for k in range(max(n, 0)):
        idx = base[:, None] + k * CS + lane
        valid = (idx >= start[:, None]) & (idx < limit[:, None])
        pk = feats[:, idx.clamp(0, max(feats.shape[1] - 1, 0))].permute(1, 2, 0)
        yield idx, valid, pk, _power(pk, px, py)


def raster_work(feats, tile_start, tile_end, gx) -> dict:
    """The forward's and the backward's work on one frame's sorted entries
    ``feats`` [10, E] (x, y, conic a/b/c, opacity, r, g, b, invdepth) and
    tile ranges: {"fwd": {...}, "bwd": {...}}, each with its pair counts
    by class, ``entries``, ``bytes`` and ``ops``."""
    num_tiles = tile_start.shape[0]
    dev = feats.device
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    f = dict(entries=zero, culled=zero, faint=zero, stopping=zero,
             composited=zero)
    U = torch.ones((num_tiles, PIX), device=dev)
    last = tile_start.to(torch.int64)[:, None].expand(num_tiles, PIX)
    for idx, valid, pk, power in _chunks(feats, tile_start, tile_end, gx):
        alpha = torch.where(valid[..., None], _alpha(pk, power), 0.0)
        before, after = _transmittance(alpha, U)
        reached = valid[..., None] & (before >= 1e-4)
        culled = reached & (power > 0.0)
        hit = reached & (alpha > 0.0)
        stop = hit & (after < 1e-4)
        f["entries"] = f["entries"] + reached.any(-1).sum()
        f["culled"] = f["culled"] + culled.sum()
        f["faint"] = f["faint"] + (reached & ~culled & ~hit).sum()
        f["stopping"] = f["stopping"] + stop.sum()
        f["composited"] = f["composited"] + (hit & ~stop).sum()
        kept = hit & ~stop
        last = torch.maximum(last, torch.amax(
            torch.where(kept, idx[..., None] + 1, 0), dim=1))
        U = after[..., -1, :]
    fwd = {k: int(v) for k, v in f.items()}
    fwd["bytes"] = 4 * (fwd["entries"] * NFEAT + 2 * num_tiles
                        + num_tiles * NOUT * PIX)
    fwd["ops"] = sum(K1_OPS[k] * fwd[k] for k in K1_OPS)
    fwd["tiles"] = num_tiles

    b = dict(entries=zero, culled=zero, faint=zero, composited=zero)
    lastl = last[:, None, :]
    for idx, valid, pk, power in _chunks(feats, tile_start, tile_end, gx):
        alpha = torch.where(valid[..., None], _alpha(pk, power), 0.0)
        visited = valid[..., None] & (idx[..., None] < lastl)
        culled = visited & (power > 0.0)
        hit = visited & (alpha > 0.0)
        b["entries"] = b["entries"] + visited.any(-1).sum()
        b["culled"] = b["culled"] + culled.sum()
        b["faint"] = b["faint"] + (visited & ~culled & ~hit).sum()
        b["composited"] = b["composited"] + hit.sum()
    bwd = {k: int(v) for k, v in b.items()}
    bwd["bytes"] = 4 * (bwd["entries"] * (NFEAT + 1) + 2 * num_tiles
                        + num_tiles * PIX * (2 + NOUT)
                        + NFEAT * feats.shape[1])
    bwd["ops"] = sum(K3_OPS[k] * bwd[k] for k in K3_OPS)
    return {"fwd": fwd, "bwd": bwd}


def frame_work(params: dict, view_cam: R.Camera) -> dict:
    """The work of one frame of ``params`` (generation-order leaves, as
    ``reference.render.project`` takes them) from ``view_cam``: its
    entries after the per-tile cut and the rasterizers' work on them."""
    with torch.no_grad():
        proj = R.project(params, view_cam)
        bins = R.bin_tiles(proj, view_cam.width, view_cam.height)
        g = bins.gid
        invd = 1.0 / torch.clamp_min(proj.depth, 1e-6)
        feats = torch.cat([proj.mean2d[g], proj.conic[g],
                           proj.opacity[g, None], proj.rgb[g],
                           invd[g, None]], 1).T.contiguous().float()
        work = raster_work(feats, bins.tile_start, bins.tile_end, bins.gx)
    work["entries"] = int(g.numel())
    return work


def bound_s(work: dict) -> float:
    """The least time the chip could take: the larger of the operations
    over the FP32 peak and the bytes over the memory bandwidth."""
    return max(work["ops"] / PEAK_FP32, work["bytes"] / HBM_BYTES_PER_S)


def iteration_ops(alive: int, pixels: int, frame: dict) -> float:
    """The FP32 operations one training iteration needs: the alive
    Gaussians' preprocess forward and backward and their Adam, L1 and
    SSIM forward and backward on three channels, and the rasterizers'
    and the fold's counted work."""
    rows = 59                                   # parameters per Gaussian
    return (alive * (PREPROCESS_OPS * (1 + BACKWARD_FACTOR) + rows * ADAM_OPS)
            + 3 * pixels * (SSIM_OPS + L1_OPS) * (1 + BACKWARD_FACTOR)
            + frame["fwd"]["ops"] + frame["bwd"]["ops"]
            + FOLD_OPS_PER_ENTRY * frame["entries"])


def view_ops(alive: int, frame: dict) -> float:
    """The FP32 operations one view needs: the alive Gaussians'
    preprocess and the forward rasterizer's counted work."""
    return alive * PREPROCESS_OPS + frame["fwd"]["ops"]
