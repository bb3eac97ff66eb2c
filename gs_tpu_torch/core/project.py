"""EWA projection (the rasterizer "preprocess" stage) — port of
``gs_tpu/core/project.py``, batched over N as flat float32 channels.

Behavioral spec (ref: gaussian_renderer/__init__.py:32-109):

* frustum cull at view z <= 0.2
* perspective division with +1e-7 guard
* EWA: cov2d = J W Sigma W^T J^T with the Jacobian's (x,y)/z clamped to
  1.3*tan(fov); +0.3 px low-pass on the diagonal
* antialiasing (Mip-Splatting) rescales opacity by
  sqrt(max(2.5e-5, det(cov)/det(cov+0.3 I)))
* conic = inverse of the dilated 2x2 covariance
* radius = ceil(3 * sqrt(max eigenvalue)), eigen-discriminant clamped at 0.1
* pixel coords: ((ndc + 1) * S - 1) / 2
* SH -> RGB for the active degree with clamp at max(c + 0.5, 0)
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .camera import Camera
from .gaussians import GaussianParams
from .sh import eval_sh_channels

NEAR_CULL_Z = 0.2
LOWPASS = 0.3
AA_DET_CLAMP = 0.000025


class Projected(NamedTuple):
    """Per-Gaussian screen-space quantities (all [N, ...])."""
    mean2d: torch.Tensor    # [N, 2] pixel coordinates
    conic: torch.Tensor     # [N, 3] inverse 2D covariance (a, b, c)
    depth: torch.Tensor     # [N] view-space z
    radius: torch.Tensor    # [N] int32, 0 => invisible
    rgb: torch.Tensor       # [N, 3]
    opacity: torch.Tensor   # [N] effective opacity (sigmoid, AA-scaled)
    visible: torch.Tensor   # [N] bool (radius > 0)
    radius_cull: Optional[torch.Tensor] = None  # [N, 2] int32 (rx, ry), each
    # <= radius: opacity-aware binning half-widths (beyond them alpha < 1/255
    # everywhere, so culling those tiles is exact). ``radius`` keeps the
    # reference's 3-sigma value for the densification semantics.


def _project_channels(camera: Camera, x, y, z):
    """View-space position and pixel coordinates as flat [N] channels."""
    V = camera.world_view
    P = camera.full_proj
    vx = V[0, 0] * x + V[0, 1] * y + V[0, 2] * z + V[0, 3]
    vy = V[1, 0] * x + V[1, 1] * y + V[1, 2] * z + V[1, 3]
    vz = V[2, 0] * x + V[2, 1] * y + V[2, 2] * z + V[2, 3]
    hx = P[0, 0] * x + P[0, 1] * y + P[0, 2] * z + P[0, 3]
    hy = P[1, 0] * x + P[1, 1] * y + P[1, 2] * z + P[1, 3]
    hw = P[3, 0] * x + P[3, 1] * y + P[3, 2] * z + P[3, 3]
    p_w = 1.0 / (hw + 1e-7)
    W = float(camera.width)
    H = float(camera.height)
    pix_x = ((hx * p_w + 1.0) * W - 1.0) * 0.5
    pix_y = ((hy * p_w + 1.0) * H - 1.0) * 0.5
    return vx, vy, vz, pix_x, pix_y


def _cov3d_channels(ls, scaling_modifier, q):
    """3D covariance as 6 flat channels (xx, xy, xz, yy, yz, zz) from
    log-scale channels ``ls`` (3-tuple) and quat channels ``q`` (4-tuple).
    Same math as build_scaling_rotation + L L^T (utils/general_utils.py)."""
    qn = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    r = q[0] / qn
    qx = q[1] / qn
    qy = q[2] / qn
    qz = q[3] / qn
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - r * qz)
    r02 = 2 * (qx * qz + r * qy)
    r10 = 2 * (qx * qy + r * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - r * qx)
    r20 = 2 * (qx * qz - r * qy)
    r21 = 2 * (qy * qz + r * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    s0 = scaling_modifier * torch.exp(ls[0])
    s1 = scaling_modifier * torch.exp(ls[1])
    s2 = scaling_modifier * torch.exp(ls[2])
    a0, a1, a2 = s0 * s0, s1 * s1, s2 * s2   # Sigma = R diag(s^2) R^T
    xx = a0 * r00 * r00 + a1 * r01 * r01 + a2 * r02 * r02
    xy = a0 * r00 * r10 + a1 * r01 * r11 + a2 * r02 * r12
    xz = a0 * r00 * r20 + a1 * r01 * r21 + a2 * r02 * r22
    yy = a0 * r10 * r10 + a1 * r11 * r11 + a2 * r12 * r12
    yz = a0 * r10 * r20 + a1 * r11 * r21 + a2 * r12 * r22
    zz = a0 * r20 * r20 + a1 * r21 * r21 + a2 * r22 * r22
    return xx, xy, xz, yy, yz, zz


def _cov2d_channels(camera: Camera, vx, vy, vz, sig):
    """EWA projection as flat channels; ``sig`` = 6-tuple (xx..zz).
    cov2d = (J W) Sigma (J W)^T with the clamped Jacobian, +0.3 px low-pass."""
    limx = 1.3 * camera.tan_fovx
    limy = 1.3 * camera.tan_fovy
    # anything at or behind the near plane is frustum-culled, so clamping z
    # is exact for every visible gaussian and keeps culled slots NaN-free
    vz = torch.clamp_min(vz, NEAR_CULL_Z)
    txtz = vx / vz
    tytz = vy / vz
    tx = torch.minimum(torch.maximum(txtz, -limx), limx) * vz
    ty = torch.minimum(torch.maximum(tytz, -limy), limy) * vz
    fx = camera.focal_x
    fy = camera.focal_y
    inv_z = 1.0 / vz
    inv_z2 = inv_z * inv_z
    # J rows: [fx/z, 0, -fx*x/z^2], [0, fy/z, -fy*y/z^2]
    j00 = fx * inv_z
    j02 = -fx * tx * inv_z2
    j11 = fy * inv_z
    j12 = -fy * ty * inv_z2
    Wr = camera.world_view[:3, :3]
    u0 = j00 * Wr[0, 0] + j02 * Wr[2, 0]
    u1 = j00 * Wr[0, 1] + j02 * Wr[2, 1]
    u2 = j00 * Wr[0, 2] + j02 * Wr[2, 2]
    v0 = j11 * Wr[1, 0] + j12 * Wr[2, 0]
    v1 = j11 * Wr[1, 1] + j12 * Wr[2, 1]
    v2 = j11 * Wr[1, 2] + j12 * Wr[2, 2]
    xx, xy, xz, yy, yz, zz = sig
    su0 = xx * u0 + xy * u1 + xz * u2
    su1 = xy * u0 + yy * u1 + yz * u2
    su2 = xz * u0 + yz * u1 + zz * u2
    sv0 = xx * v0 + xy * v1 + xz * v2
    sv1 = xy * v0 + yy * v1 + yz * v2
    sv2 = xz * v0 + yz * v1 + zz * v2
    cxx = u0 * su0 + u1 * su1 + u2 * su2
    cxy = v0 * su0 + v1 * su1 + v2 * su2
    cyy = v0 * sv0 + v1 * sv1 + v2 * sv2
    det_orig = cxx * cyy - cxy * cxy
    cxx = cxx + LOWPASS
    cyy = cyy + LOWPASS
    det_dilated = cxx * cyy - cxy * cxy
    return cxx, cxy, cyy, det_orig, det_dilated


def preprocess(params: GaussianParams, camera: Camera, *,
               active_sh_degree: int,
               scaling_modifier: float = 1.0,
               antialiasing: bool = False,
               alive: Optional[torch.Tensor] = None,
               override_color: Optional[torch.Tensor] = None,
               cov3d_precomp: Optional[torch.Tensor] = None) -> Projected:
    """Full per-Gaussian preprocess: cull, project, EWA, SH shading.

    Dead (padding) slots are forced invisible via ``alive``.
    """
    x, y, z = params.xyz[:, 0], params.xyz[:, 1], params.xyz[:, 2]
    ls = tuple(params.log_scale[:, i] for i in range(3))
    quat = tuple(params.quat[:, i] for i in range(4))
    lop = params.logit_opacity[:, 0]
    coeffs = None
    if override_color is None:
        coeffs = ([params.sh_dc[:, 0, c] for c in range(3)] +
                  [params.sh_rest[:, k, c]
                   for k in range(params.sh_rest.shape[1])
                   for c in range(3)])
    return _preprocess_from_channels(
        camera, x, y, z, ls, quat, lop, coeffs,
        active_sh_degree=active_sh_degree,
        scaling_modifier=scaling_modifier, antialiasing=antialiasing,
        alive=alive, override_color=override_color,
        cov3d_precomp=cov3d_precomp)


def _preprocess_from_channels(camera: Camera, x, y, z, ls, quat, lop,
                              coeffs, *, active_sh_degree: int,
                              scaling_modifier, antialiasing: bool,
                              alive, override_color,
                              cov3d_precomp) -> Projected:
    """Shared flat-channel preprocess core. ``coeffs`` is the SH coefficient
    channel list ordered (band, color) with band 0 = DC; may be None when
    ``override_color`` is given."""
    vx, vy, vz, pix_x, pix_y = _project_channels(camera, x, y, z)
    depth = vz
    in_front = depth > NEAR_CULL_Z

    if cov3d_precomp is None:
        sig = _cov3d_channels(ls, scaling_modifier, quat)
    else:
        sig = tuple(cov3d_precomp[:, i] for i in range(6))
    cxx, cxy, cyy, det_orig, det = _cov2d_channels(camera, vx, vy, vz, sig)

    det_ok = det != 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    pix = torch.stack([pix_x, pix_y], dim=-1)
    conic = torch.stack([cyy * inv_det,
                         -cxy * inv_det,
                         cxx * inv_det], dim=-1)

    mid = 0.5 * (cxx + cyy)
    disc = torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    lambda1 = mid + disc
    lambda2 = mid - disc
    radius_f = torch.ceil(3.0 * torch.sqrt(torch.maximum(lambda1, lambda2)))

    opacity = torch.sigmoid(lop)
    if antialiasing:
        h_scale = torch.sqrt(torch.clamp_min(det_orig / det, AA_DET_CLAMP))
        opacity = opacity * h_scale

    visible = in_front & det_ok
    if alive is not None:
        visible = visible & alive
    radius = torch.where(visible, radius_f, 0.0).to(torch.int32)
    visible = radius > 0

    # opacity-aware per-axis cull radii: alpha >= 1/255 only inside the
    # ellipse d^T Sigma^-1 d <= 2 ln(255 op), whose bounding box has
    # half-widths sqrt(2 ln(255 op) * Sigma_xx|yy); +1 px guards the
    # tile_rect max-side convention and f32 rounding at tangency
    log_term = torch.log(torch.clamp_min(255.0 * opacity, 1e-12))
    two_l = 2.0 * torch.clamp_min(log_term, 0.0)
    rcx = torch.ceil(torch.sqrt(two_l * torch.clamp_min(cxx, 0.0))) + 1.0
    rcy = torch.ceil(torch.sqrt(two_l * torch.clamp_min(cyy, 0.0))) + 1.0
    keep = visible & (log_term > 0.0)
    radius_cull = torch.stack([
        torch.where(keep, torch.minimum(rcx, radius_f), 0.0),
        torch.where(keep, torch.minimum(rcy, radius_f), 0.0)], dim=-1
    ).to(torch.int32)

    if override_color is not None:
        rgb = override_color
    else:
        cc = camera.camera_center
        dx, dy, dz = x - cc[0], y - cc[1], z - cc[2]
        # padding slots can sit exactly at the camera center; the guard
        # keeps their direction finite and is inert for real gaussians
        inv_n = 1.0 / torch.sqrt(torch.clamp_min(dx * dx + dy * dy + dz * dz,
                                                 1e-18))
        dx, dy, dz = dx * inv_n, dy * inv_n, dz * inv_n
        rgb = torch.stack([
            eval_sh_channels(active_sh_degree, coeffs[c::3], dx, dy, dz)
            for c in range(3)], dim=-1)
        rgb = torch.clamp_min(rgb + 0.5, 0.0)

    return Projected(
        mean2d=pix,
        conic=conic,
        depth=depth,
        radius=radius,
        rgb=rgb,
        opacity=opacity,
        visible=visible,
        radius_cull=radius_cull,
    )


def tile_rect(mean2d: torch.Tensor, radius: torch.Tensor,
              grid_x: int, grid_y: int, tile_x: int, tile_y: int,
              radius_y: Optional[torch.Tensor] = None):
    """Tile-span rectangle per Gaussian, clamped to the tile grid.

    Matches the CUDA getRect math; returns (rx0, ry0, rx1, ry1) int32
    half-open ranges. ``radius_y`` (defaults to ``radius``) allows an
    anisotropic span for the opacity-aware cull bbox.
    """
    rx = radius.to(torch.float32)
    ry = rx if radius_y is None else radius_y.to(torch.float32)

    def span(v, n):
        # clamp before the cast: XLA's float->int32 saturates, torch's
        # cast of an out-of-range float is undefined
        return torch.clamp(torch.floor(v), 0, n).to(torch.int32)

    rx0 = span((mean2d[:, 0] - rx) / tile_x, grid_x)
    ry0 = span((mean2d[:, 1] - ry) / tile_y, grid_y)
    rx1 = span((mean2d[:, 0] + rx + tile_x - 1) / tile_x, grid_x)
    ry1 = span((mean2d[:, 1] + ry + tile_y - 1) / tile_y, grid_y)
    return rx0, ry0, rx1, ry1
