"""Render facade — port of ``gs_tpu/render.py`` (forward only).

Takes a camera, the Gaussian parameters and a background color; returns
``image`` [3,H,W], ``invdepth`` [1,H,W], ``final_T`` [H,W], ``radii`` and
``visibility`` [N], and the binning diagnostics, like the reference facade
(ref: gaussian_renderer/__init__.py:18-121).

Backends: ``cuda`` (the kernels K2 and K1; ``auto`` means ``cuda``),
``binned`` and ``depthwise`` (the plain oracles). The device is the
camera's; parameters and background must be on it. A CPU camera runs each
kernel's plain version, a CUDA camera the kernels.

Gradients are not ported yet: the raster backward (K3) and the gradient
fold (K4) come with the training slice, so a render that would need them
raises ``NotImplementedError``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .core.camera import Camera
from .core.gaussians import GaussianParams
from .core.project import Projected, preprocess
from .ops.binning import bin_gaussians
from .ops.rasterize import rasterize
from .ops.rasterize_plain import rasterize_binned, rasterize_depthwise

TILE_X = 16
TILE_Y = 16
BACKENDS = ("depthwise", "binned", "cuda")


class RenderOutput(NamedTuple):
    image: torch.Tensor          # [3, H, W]
    invdepth: torch.Tensor       # [1, H, W]
    final_T: torch.Tensor        # [H, W]
    radii: torch.Tensor          # [N] int32
    visibility: torch.Tensor     # [N] bool
    num_duplicates: torch.Tensor  # [] int32 (binned backends)
    max_tile_len: torch.Tensor   # [] longest per-tile list
    overflow: torch.Tensor       # [] bool
    num_valid: torch.Tensor      # [] int32 entries surviving the exact
    # cull — the entries the raster kernel composites


def resolve_backend(backend: str) -> str:
    """'auto' is the kernel path, on every device."""
    backend = "cuda" if backend == "auto" else backend
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; one of auto, "
                         + ", ".join(BACKENDS))
    return backend


def raster_lever_kwargs(raster) -> dict:
    """render()/render_projected() kwargs from a RasterConfig's levers, so
    every caller runs the configured pipeline."""
    return dict(exact_cull=getattr(raster, "exact_cull", False),
                bf16_features=getattr(raster, "bf16_features", False))


def _check_no_grad(*tensors):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            "gs_tpu_torch renders forward only: gradients need the raster "
            "backward (K3) and gradient fold (K4) kernels, which come with "
            "the training slice of the port. Render under torch.no_grad() "
            "or from tensors that do not require grad.")


def render(camera: Camera, params: GaussianParams, bg: torch.Tensor, *,
           active_sh_degree: int,
           scaling_modifier: float = 1.0,
           antialiasing: bool = False,
           alive: Optional[torch.Tensor] = None,
           override_color: Optional[torch.Tensor] = None,
           convert_SHs_python: bool = False,
           compute_cov3D_python: bool = False,
           backend: str = "auto",
           dup_capacity: int = 1 << 18,
           max_per_tile: int = 1024,
           chunk: int = 64,
           bf16_features: bool = False,
           exact_cull: bool = False) -> RenderOutput:
    """Render one view on the camera's device.

    ``convert_SHs_python`` / ``compute_cov3D_python`` recompute SH shading
    / the 3D covariance outside the preprocess and feed them back as
    override_color / cov3d_precomp — the reference's cross-check switches
    (ref: gaussian_renderer/__init__.py:63-84); the math is identical.
    """
    for name, t in (("params", params.xyz), ("bg", bg)):
        if t.device != camera.device:
            raise ValueError(f"{name} on {t.device}, camera on {camera.device}")
    cov3d_precomp = None
    if compute_cov3D_python:
        from .core.gaussians import covariance_3d, get_scaling
        cov3d_precomp = covariance_3d(get_scaling(params), scaling_modifier,
                                      params.quat)
    if convert_SHs_python and override_color is None:
        from .core.sh import eval_sh
        dirs = params.xyz - camera.camera_center[None, :]
        dirs = dirs / torch.clamp_min(
            torch.linalg.norm(dirs, dim=-1, keepdim=True), 1e-9)
        feats = torch.cat([params.sh_dc, params.sh_rest], dim=1)
        sh = feats.transpose(1, 2)
        override_color = torch.clamp_min(
            eval_sh(active_sh_degree, sh, dirs) + 0.5, 0.0)
    proj = preprocess(params, camera, active_sh_degree=active_sh_degree,
                      scaling_modifier=scaling_modifier,
                      antialiasing=antialiasing, alive=alive,
                      override_color=override_color,
                      cov3d_precomp=cov3d_precomp)
    return render_projected(proj, camera.width, camera.height, bg,
                            backend=backend, dup_capacity=dup_capacity,
                            max_per_tile=max_per_tile, chunk=chunk,
                            bf16_features=bf16_features,
                            exact_cull=exact_cull)


def render_projected(proj: Projected, width: int, height: int,
                     bg: torch.Tensor, *, backend: str = "auto",
                     dup_capacity: int = 1 << 18, max_per_tile: int = 1024,
                     chunk: int = 64, bf16_features: bool = False,
                     exact_cull: bool = False) -> RenderOutput:
    backend = resolve_backend(backend)
    _check_no_grad(*proj, bg)
    if bf16_features:
        raise NotImplementedError(
            "bf16_features (bf16 feature streaming) is not ported yet")
    dev = proj.depth.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nv = zero_i
    if backend == "depthwise":
        image, invd, finalT = rasterize_depthwise(
            proj, width, height, bg, tile_x=TILE_X, tile_y=TILE_Y, chunk=chunk)
        nd, ml, ov = zero_i, zero_i, torch.zeros((), dtype=torch.bool, device=dev)
    elif backend == "binned":
        bins = bin_gaussians(proj, width, height, TILE_X, TILE_Y, dup_capacity)
        image, invd, finalT = rasterize_binned(
            proj, bins, width, height, bg, tile_x=TILE_X, tile_y=TILE_Y,
            max_per_tile=max_per_tile, chunk=chunk)
        nd = bins.num_duplicates
        ml = torch.max(bins.tile_end - bins.tile_start)
        ov = bins.overflow | (ml > max_per_tile)
        nv = bins.num_valid
    else:
        image, invd, finalT, nd, ml, ov, nv = rasterize(
            proj, width, height, bg, max_per_tile=max_per_tile,
            dup_capacity=dup_capacity, exact_cull=exact_cull)
    return RenderOutput(image=image, invdepth=invd, final_T=finalT,
                        radii=proj.radius, visibility=proj.visible,
                        num_duplicates=nd, max_tile_len=ml, overflow=ov,
                        num_valid=nv)
