"""Plain PyTorch reference of 3D Gaussian Splatting's renderer (Kerbl et
al., SIGGRAPH 2023; their ``diff-gaussian-rasterization``): projection, EWA
splatting, spherical harmonics, tile binning and front-to-back alpha
compositing, differentiable through autograd.

It imports nothing of the program under test and is written from the
published semantics:

* cull at view-space z <= 0.2; pixel coordinates ((ndc + 1) * S - 1) / 2;
* cov2d = J W Sigma W^T J^T, the Jacobian's x/z and y/z clamped to
  1.3 tan(fov / 2), + 0.3 px on the diagonal; conic = its inverse;
  radius = ceil(3 sqrt(largest eigenvalue)), the discriminant clamped at
  0.1;
* colour = max(SH(direction from the camera) + 0.5, 0), degree 3;
* a Gaussian covers the 16x16 tiles of its rectangle: the 3-sigma radius,
  cut per axis to the box where opacity * exp(power) >= 1/255 (beyond it
  every pixel skips the Gaussian, so the cut changes no pixel) plus 1 px;
* per pixel, in depth order (ties by index): alpha = min(0.99, opacity *
  exp(power)), skipped when power > 0 or alpha < 1/255; the walk stops
  before the contribution that would take T below 1e-4;
  image = sum(alpha T c) + T_final * background.

Everything runs in the dtype of the parameters it is given (float32 for
the reference; bfloat16 for the lower-precision control). Compositing runs
in blocks of tiles and in chunks of each tile's list, so that a frame of
millions of Gaussians fits the card; :func:`render_backward` recomputes
each block with autograd and hands its gradient to the projected
quantities, then once through the projection to the parameters.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

TILE = 16
NEAR = 0.2
LOWPASS = 0.3
ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
CHUNK = 128                 # entries of a tile's list per compositing step
BLOCK_PAIRS = 1 << 25       # (entry, pixel) pairs per block and chunk
GRAD_PAIRS = 1 << 23        # the same with autograd, which keeps each chunk

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Camera(NamedTuple):
    """A pinhole camera: world -> view rotation ``R`` [3, 3] (rows: right,
    down, forward) and translation ``t`` [3], its centre, the tangents of
    the half fields of view, and the image size."""
    R: torch.Tensor
    t: torch.Tensor
    center: torch.Tensor
    tan_fovx: float
    tan_fovy: float
    width: int
    height: int


class Projected(NamedTuple):
    mean2d: torch.Tensor    # [N, 2]
    conic: torch.Tensor     # [N, 3] (a, b, c) of the inverse 2D covariance
    opacity: torch.Tensor   # [N]
    rgb: torch.Tensor       # [N, 3]
    depth: torch.Tensor     # [N]
    cov: torch.Tensor       # [N, 3] (xx, xy, yy) dilated 2D covariance
    radius: torch.Tensor    # [N] float, 0 where culled


def make_camera(center, R, fovx: float, fovy: float, width: int,
                height: int, device, dtype=torch.float32) -> Camera:
    """``center`` [3] and the world -> view rotation ``R`` [3, 3] (numpy or
    lists) as a :class:`Camera` on ``device``."""
    Rt = torch.as_tensor(R, dtype=torch.float64)
    c = torch.as_tensor(center, dtype=torch.float64)
    t = -(Rt @ c)
    return Camera(Rt.to(device, dtype), t.to(device, dtype),
                  c.to(device, dtype), math.tan(fovx / 2),
                  math.tan(fovy / 2), int(width), int(height))


def eval_sh3(sh: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Degree-3 real spherical harmonics: ``sh`` [N, 16, 3], unit
    directions ``d`` [N, 3] -> [N, 3]."""
    x, y, z = d[:, 0:1], d[:, 1:2], d[:, 2:3]
    xx, yy, zz = x * x, y * y, z * z
    basis = [
        torch.full_like(x, SH_C0),
        -SH_C1 * y, SH_C1 * z, -SH_C1 * x,
        SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy),
        SH_C2[3] * x * z, SH_C2[4] * (xx - yy),
        SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z,
        SH_C3[2] * y * (4 * zz - xx - yy),
        SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy),
        SH_C3[4] * x * (4 * zz - xx - yy), SH_C3[5] * z * (xx - yy),
        SH_C3[6] * x * (xx - 3 * yy),
    ]
    return (torch.stack(basis, dim=1) * sh).sum(dim=1)


def quat_rotation(q: torch.Tensor) -> torch.Tensor:
    """[N, 4] (w, x, y, z), normalised here -> [N, 3, 3]."""
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(-1, 3, 3)


def project(params: dict, cam: Camera) -> Projected:
    """The per-Gaussian preprocess. ``params``: xyz [N, 3], sh [N, 16, 3],
    log_scale [N, 3], quat [N, 4], logit [N]."""
    xyz = params["xyz"]
    pv = xyz @ cam.R.T + cam.t
    x, y, z = pv.unbind(-1)
    zc = torch.clamp_min(z, NEAR)          # exact for every kept Gaussian
    mean2d = torch.stack([
        ((x / (zc * cam.tan_fovx) + 1.0) * cam.width - 1.0) * 0.5,
        ((y / (zc * cam.tan_fovy) + 1.0) * cam.height - 1.0) * 0.5], -1)

    rot = quat_rotation(params["quat"])
    m = rot * torch.exp(params["log_scale"])[:, None, :]
    sigma = m @ m.transpose(1, 2)                            # [N, 3, 3]
    fx = cam.width / (2.0 * cam.tan_fovx)
    fy = cam.height / (2.0 * cam.tan_fovy)
    tx = torch.clamp(x / zc, -1.3 * cam.tan_fovx, 1.3 * cam.tan_fovx) * zc
    ty = torch.clamp(y / zc, -1.3 * cam.tan_fovy, 1.3 * cam.tan_fovy) * zc
    zero = torch.zeros_like(zc)
    J = torch.stack([fx / zc, zero, -fx * tx / (zc * zc),
                     zero, fy / zc, -fy * ty / (zc * zc)], -1).reshape(-1, 2, 3)
    T = J @ cam.R
    c2 = T @ sigma @ T.transpose(1, 2)
    cxx = c2[:, 0, 0] + LOWPASS
    cxy = c2[:, 0, 1]
    cyy = c2[:, 1, 1] + LOWPASS
    det = cxx * cyy - cxy * cxy
    conic = torch.stack([cyy / det, -cxy / det, cxx / det], -1)
    mid = 0.5 * (cxx + cyy)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam)).detach()
    keep = (z > NEAR) & (det > 0) & (radius > 0)
    radius = torch.where(keep, radius, torch.zeros_like(radius))

    d = xyz - cam.center
    d = d / d.norm(dim=-1, keepdim=True)
    rgb = torch.clamp_min(eval_sh3(params["sh"], d) + 0.5, 0.0)
    opacity = torch.sigmoid(params["logit"])
    return Projected(mean2d, conic, opacity, rgb, z,
                     torch.stack([cxx, cxy, cyy], -1), radius)


class Bins(NamedTuple):
    gid: torch.Tensor          # [E] Gaussian of each entry, by (tile, depth)
    tile_start: torch.Tensor   # [T] int64
    tile_end: torch.Tensor     # [T]
    gx: int
    gy: int
    duplicates: int            # entries before the per-tile cut


def tile_rects(proj: Projected, width: int, height: int):
    """Each Gaussian's tile rectangle [x0, x1) x [y0, y1) (int64) and its
    tile count: the 3-sigma radius cut per axis to the box where alpha can
    reach 1/255, plus 1 px."""
    gx, gy = -(-width // TILE), -(-height // TILE)
    with torch.no_grad():
        op = proj.opacity.float()
        lim = 2.0 * torch.log(torch.clamp_min(255.0 * op, 1e-12))
        cov = proj.cov.float()
        rad = proj.radius.float()
        rx = torch.minimum(torch.ceil(torch.sqrt(
            torch.clamp_min(lim, 0) * torch.clamp_min(cov[:, 0], 0))) + 1, rad)
        ry = torch.minimum(torch.ceil(torch.sqrt(
            torch.clamp_min(lim, 0) * torch.clamp_min(cov[:, 2], 0))) + 1, rad)
        keep = (rad > 0) & (lim > 0)
        mx, my = proj.mean2d[:, 0].float(), proj.mean2d[:, 1].float()

        def span(v, n):
            return torch.clamp(torch.floor(v), 0, n).to(torch.int64)

        x0 = span((mx - rx) / TILE, gx)
        x1 = span((mx + rx + TILE - 1) / TILE, gx)
        y0 = span((my - ry) / TILE, gy)
        y1 = span((my + ry + TILE - 1) / TILE, gy)
        counts = torch.where(keep, (x1 - x0) * (y1 - y0), 0)
    return x0, x1, y0, y1, counts, gx, gy


def quad_min_rect(ex, ey, ca, cb, cc, x_lo, x_hi, y_lo, y_hi):
    """The least of q = ca dx^2 + 2 cb dx dy + cc dy^2 over a rectangle,
    (dx, dy) = point - mean: 0 with the mean inside, else the least of the
    four edges' minima (each edge's restriction is a convex parabola)."""
    dx0, dx1, dy0, dy1 = x_lo - ex, x_hi - ex, y_lo - ey, y_hi - ey
    ca = ca + 1e-20
    cc = cc + 1e-20

    def q(dx, dy):
        return ca * dx * dx + 2.0 * cb * dx * dy + cc * dy * dy

    def clip(v, lo, hi):
        return torch.minimum(torch.maximum(v, lo), hi)

    best = torch.minimum(
        torch.minimum(q(clip(-cb * dy0 / ca, dx0, dx1), dy0),
                      q(clip(-cb * dy1 / ca, dx0, dx1), dy1)),
        torch.minimum(q(dx0, clip(-cb * dx0 / cc, dy0, dy1)),
                      q(dx1, clip(-cb * dx1 / cc, dy0, dy1))))
    inside = (dx0 <= 0) & (dx1 >= 0) & (dy0 <= 0) & (dy1 >= 0)
    return torch.where(inside, torch.zeros_like(best), best)


def bin_tiles(proj: Projected, width: int, height: int,
              tile_cut: bool = True) -> Bins:
    """Entries (Gaussian, tile) ordered by tile, then depth (ties by
    index). ``tile_cut`` drops the entries whose tile no pixel of it can
    take the Gaussian into (alpha < 1/255 over the whole tile, with a
    margin for rounding), which changes no pixel."""
    x0, x1, y0, y1, counts, gx, gy = tile_rects(proj, width, height)
    dev = counts.device
    with torch.no_grad():
        depth = torch.where(counts > 0, proj.depth.float(),
                            torch.full_like(proj.depth.float(), float("inf")))
        order = torch.sort(depth, stable=True).indices
        c = counts[order]
        total = int(c.sum())
        gid = torch.repeat_interleave(order, c, output_size=total)
        first = torch.repeat_interleave(torch.cumsum(c, 0) - c, c,
                                        output_size=total)
        local = torch.arange(total, device=dev) - first
        w = (x1 - x0)[gid].clamp_min(1)
        tx = x0[gid] + local % w
        ty = y0[gid] + local // w
        if tile_cut and total:
            m = proj.mean2d.detach().float()[gid]
            k = proj.conic.detach().float()[gid]
            op = proj.opacity.detach().float()[gid]
            qmin = quad_min_rect(
                m[:, 0], m[:, 1], k[:, 0], k[:, 1], k[:, 2],
                (tx * TILE - 1).float(), (tx * TILE + TILE).float(),
                (ty * TILE - 1).float(), (ty * TILE + TILE).float())
            lim = 2.0 * torch.log(torch.clamp_min(255.0 * op, 1.0))
            keep = ~(qmin > lim * (1.0 + 1e-4) + 1e-3)
            gid, tx, ty = gid[keep], tx[keep], ty[keep]
        tile = ty * gx + tx
        tile, perm = torch.sort(tile, stable=True)
        gid = gid[perm]
        tiles = torch.arange(gx * gy, device=dev)
        start = torch.searchsorted(tile, tiles)
        end = torch.searchsorted(tile, tiles + 1)
    return Bins(gid, start, end, gx, gy, total)


def _blocks(bins: Bins, pairs: int = BLOCK_PAIRS):
    """Tiles in blocks of similar list length: (tile ids, their starts,
    lengths, the block's longest), longest lists first."""
    lens = bins.tile_end - bins.tile_start
    order = torch.argsort(lens, descending=True)
    lens_sorted = lens[order].tolist()
    i, n = 0, len(lens_sorted)
    while i < n and lens_sorted[i] > 0:
        longest = lens_sorted[i]
        per = max(1, pairs // (min(longest, CHUNK) * TILE * TILE))
        j = min(n, i + per)
        tiles = order[i:j]
        yield tiles, bins.tile_start[tiles], lens[tiles], longest
        i = j


def _tile_pixels(tiles: torch.Tensor, gx: int, dtype):
    p = torch.arange(TILE * TILE, device=tiles.device)
    px = (tiles[:, None] % gx) * TILE + p % TILE
    py = (tiles[:, None] // gx) * TILE + p // TILE
    return px.to(dtype), py.to(dtype)


def _composite_block(packets: torch.Tensor, bins: Bins, tiles, starts,
                     lens, longest: int):
    """One block of tiles: colour [Tb, 256, 3] and final T [Tb, 256],
    chunk by chunk of each list, stopping once every pixel has.
    ``packets`` [N, 9]: x, y, conic a/b/c, opacity, r, g, b."""
    dtype = packets.dtype
    px, py = _tile_pixels(tiles, bins.gx, dtype)
    tb = tiles.shape[0]
    T = torch.ones((tb, TILE * TILE), dtype=dtype, device=packets.device)
    color = torch.zeros((tb, TILE * TILE, 3), dtype=dtype,
                        device=packets.device)
    lane = torch.arange(CHUNK, device=packets.device)
    # a pixel is done at the first entry that would take T below 1e-4;
    # it composites nothing after, in this chunk or a later one
    done = torch.zeros_like(T, dtype=torch.bool)
    for k0 in range(0, longest, CHUNK):
        idx = k0 + lane                                   # [CHUNK]
        valid = idx[None, :] < lens[:, None]              # [Tb, CHUNK]
        pos = torch.where(valid, starts[:, None] + idx, 0)
        g = torch.where(valid, bins.gid[pos], 0)
        pk = packets[g]                                   # [Tb, CHUNK, 9]
        dx = pk[..., 0:1] - px[:, None, :]
        dy = pk[..., 1:2] - py[:, None, :]
        power = (-0.5 * (pk[..., 2:3] * dx * dx + pk[..., 4:5] * dy * dy)
                 - pk[..., 3:4] * dx * dy)
        # power > 0 is skipped; the clamp keeps exp finite for autograd
        alpha = torch.clamp_max(
            pk[..., 5:6] * torch.exp(torch.clamp_max(power, 0.0)), ALPHA_MAX)
        skip = (power > 0) | (alpha < ALPHA_MIN) | ~valid[..., None]
        alpha = torch.where(skip, torch.zeros_like(alpha), alpha)
        lg = torch.log1p(-alpha)
        cum = torch.cumsum(lg, dim=1)
        t_after = T[:, None, :] * torch.exp(cum)
        t_before = T[:, None, :] * torch.exp(cum - lg)
        live = (t_after >= T_EPS) & ~done[:, None, :]
        w = torch.where(live, alpha * t_before, torch.zeros_like(alpha))
        color = color + torch.einsum("tkp,tkc->tpc", w, pk[..., 6:9])
        T = T * torch.exp(torch.where(live, lg, torch.zeros_like(lg)).sum(1))
        done = done | (~live & ~skip).any(1)
        if bool(done.all()):
            break
    return color, T


def _packets(proj: Projected) -> torch.Tensor:
    return torch.cat([proj.mean2d, proj.conic, proj.opacity[:, None],
                      proj.rgb], dim=1)


def _untile(x: torch.Tensor, bins: Bins, width: int, height: int):
    """[gx * gy, 256, C] -> [C, H, W]."""
    c = x.shape[-1]
    x = x.reshape(bins.gy, bins.gx, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    return x.reshape(c, bins.gy * TILE, bins.gx * TILE)[:, :height, :width]


def composite(proj: Projected, bins: Bins, width: int, height: int,
              bg: torch.Tensor) -> torch.Tensor:
    """The image [3, H, W] (no autograd)."""
    with torch.no_grad():
        packets = _packets(proj).detach()
        dtype = packets.dtype
        n_t = bins.gx * bins.gy
        color = torch.zeros((n_t, TILE * TILE, 3), dtype=dtype,
                            device=packets.device)
        T = torch.ones((n_t, TILE * TILE), dtype=dtype, device=packets.device)
        for tiles, starts, lens, longest in _blocks(bins):
            c, t = _composite_block(packets, bins, tiles, starts, lens,
                                    longest)
            color[tiles] = c
            T[tiles] = t
        full = color + T[..., None] * bg.to(dtype)
        return _untile(full, bins, width, height)


class fp32:
    """Float32 matrix products and convolutions without TF32 inside, the
    previous settings restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32,
                      torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.saved


def render(params: dict, cam: Camera, bg: torch.Tensor) -> torch.Tensor:
    """The image [3, H, W] of ``params`` from ``cam`` (no autograd)."""
    with torch.no_grad(), fp32():
        proj = project(params, cam)
        bins = bin_tiles(proj, cam.width, cam.height)
        return composite(proj, bins, cam.width, cam.height, bg)


def render_backward(params: dict, cam: Camera, bg: torch.Tensor,
                    loss_fn) -> tuple[torch.Tensor, torch.Tensor]:
    """Render, take ``loss_fn(image)``, and leave d loss / d param in each
    ``params`` leaf's ``.grad`` (the leaves must require grad). Returns
    (loss, image), both detached. The image is rendered without autograd;
    the loss's gradient with respect to it is then taken back block by
    block, each block recomputed with autograd."""
    proj = project(params, cam)
    bins = bin_tiles(proj, cam.width, cam.height)
    with torch.no_grad():
        image = composite(proj, bins, cam.width, cam.height, bg)
    img = image.detach().requires_grad_(True)
    loss = loss_fn(img)
    (d_img,) = torch.autograd.grad(loss, img)
    gx, gy = bins.gx, bins.gy
    pad = torch.zeros((3, gy * TILE, gx * TILE), dtype=d_img.dtype,
                      device=d_img.device)
    pad[:, :cam.height, :cam.width] = d_img
    d_tiles = pad.reshape(3, gy, TILE, gx, TILE).permute(1, 3, 2, 4, 0) \
        .reshape(gx * gy, TILE * TILE, 3)
    packets = _packets(proj)
    leaf = packets.detach().requires_grad_(True)
    for tiles, starts, lens, longest in _blocks(bins, GRAD_PAIRS):
        c, t = _composite_block(leaf, bins, tiles, starts, lens, longest)
        out = c + t[..., None] * bg.to(c.dtype)
        torch.autograd.backward(out, d_tiles[tiles])
    d_packets = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    torch.autograd.backward(packets, d_packets)
    return loss.detach(), image


def _window(size: int = 11, sigma: float = 1.5, dtype=torch.float32,
            device="cpu") -> torch.Tensor:
    xs = torch.arange(size, dtype=torch.float64) - size // 2
    g = torch.exp(-xs * xs / (2 * sigma * sigma))
    g = g / g.sum()
    return (g[:, None] * g[None, :]).to(device, dtype)


def ssim(img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images (11x11 Gaussian window, sigma
    1.5, zero padding, C1 = 0.01^2, C2 = 0.03^2), as 3DGS's loss_utils."""
    c = img1.shape[0]
    w = _window(dtype=img1.dtype, device=img1.device)[None, None]
    w = w.expand(c, 1, 11, 11).contiguous()

    def blur(x):
        return torch.nn.functional.conv2d(x[None], w, padding=5,
                                          groups=c)[0]

    mu1, mu2 = blur(img1), blur(img2)
    s11 = blur(img1 * img1) - mu1 * mu1
    s22 = blur(img2 * img2) - mu2 * mu2
    s12 = blur(img1 * img2) - mu1 * mu2
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    m = ((2 * mu1 * mu2 + c1) * (2 * s12 + c2)) / (
        (mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2))
    return m.mean()


def frame_bytes(image: torch.Tensor) -> torch.Tensor:
    """[3, H, W] -> [H, W, 3] uint8, truncating, as a viewer's wire frame."""
    return (torch.clamp(image.float(), 0.0, 1.0) * 255).to(torch.uint8) \
        .permute(1, 2, 0).contiguous()


def bytes_off(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of byte values in which two frames differ."""
    return float((a != b).float().mean())


def entries_of(params: dict, cam: Camera) -> dict:
    """What a frame asks of the binning: entries before and after the
    per-tile cut, and the longest tile list."""
    with torch.no_grad():
        proj = project(params, cam)
        bins = bin_tiles(proj, cam.width, cam.height)
        longest = int((bins.tile_end - bins.tile_start).max()) \
            if bins.tile_end.numel() else 0
    return {"duplicates": bins.duplicates, "entries": int(bins.gid.numel()),
            "longest": longest}
