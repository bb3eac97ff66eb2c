"""Render facade — port of ``gs_tpu/render.py``.

Takes a camera, the Gaussian parameters and a background color; returns
``image`` [3,H,W], ``invdepth`` [1,H,W], ``final_T`` [H,W], ``radii`` and
``visibility`` [N], and the binning diagnostics, like the reference facade
(ref: gaussian_renderer/__init__.py:18-121).

Backends: ``cuda`` (the kernels K2 and K1; ``auto`` means ``cuda``),
``binned`` and ``depthwise`` (the plain oracles). The device is the
camera's; parameters and background must be on it. A CPU camera runs each
kernel's plain version, a CUDA camera the kernels.

Every backend is differentiable with respect to the parameters, the
background and the ``Projected`` fields: ``cuda`` through its custom
backward (K1g forward, K3 raster backward, K4 gradient fold), ``binned``
and ``depthwise`` through plain autograd, as the JAX package's oracles.

``render_grown`` is the no-grad entry point of every caller that must not
return a truncated image (the render CLI, ``Trainer.evaluate`` and
``render_view``, the viewer): one host read of ``overflow`` per view, and a
second render at grown buffers when it is set.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from .core.camera import Camera
from .core.gaussians import GaussianParams
from .core.project import Projected, preprocess
from .ops.binning import F32_EXACT, bin_gaussians
from .ops.rasterize import rasterize
from .ops.rasterize_plain import rasterize_binned, rasterize_depthwise

TILE_X = 16
TILE_Y = 16
BACKENDS = ("depthwise", "binned", "cuda")
# the largest 512-aligned duplicate buffer the binning accepts (offsets ride
# the K2 table as exact float32 values, below 2^24)
MAX_DUP_CAPACITY = F32_EXACT - 512


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
    band_duplicates: Optional[torch.Tensor] = None  # [k] per-band duplicate
    # counts (multi-GPU path only): max/mean is the band imbalance
    band_visible: Optional[torch.Tensor] = None  # [k] per-shard visible
    # Gaussian counts (multi-GPU path only): sizes visible_capacity
    band_work: Optional[torch.Tensor] = None  # [k] per-band num_valid
    # (multi-GPU path only): the entries each band's kernel composites


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


def overflow_changes(dup_capacity: int, max_per_tile: int,
                     num_duplicates: int, max_tile_len: int,
                     visible_capacity: int = 0, max_visible: int = 0) -> dict:
    """Which buffer overflowed, and its new size: the rule the trainer's
    replay and every no-grad render that grows share. Under a mesh
    ``num_duplicates`` is the largest band's (the buffer is per band) and
    a set ``visible_capacity`` below the largest shard's visible count
    ``max_visible`` grows to the power of two above it
    (``gs_tpu/train/loop.py:595-614``)."""
    changes = {}
    if num_duplicates > dup_capacity and dup_capacity < MAX_DUP_CAPACITY:
        # tiered, not pow2: every D-linear stage (expansion, the sorts,
        # the fold) scales with the capacity; 1.2x headroom, 512-aligned,
        # and never past what the binning can address
        changes["dup_capacity"] = min(max(
            -(-int(num_duplicates * 1.2) // 512) * 512,
            dup_capacity + 512), MAX_DUP_CAPACITY)
    if max_tile_len > max_per_tile:
        changes["max_per_tile"] = 1 << int(
            math.ceil(math.log2(max(max_tile_len + 1, 2))))
    if 0 < visible_capacity < max_visible:
        changes["visible_capacity"] = 1 << int(
            math.ceil(math.log2(max(max_visible + 1, 2))))
    return changes


def render_grown(camera: Camera, params: GaussianParams, bg: torch.Tensor,
                 raster, *, label: str = "view", mesh=None, **kwargs):
    """``render`` with ``raster``'s backend and buffers, read back once: a
    view that overflowed them renders again with buffers sized from its
    ``num_duplicates`` and ``max_tile_len`` (``overflow_changes``), and a
    view that overflows even at ``MAX_DUP_CAPACITY`` is reported. Returns
    (output, the RasterConfig it rendered with); ``raster`` itself is
    never changed. Without overflow the output is ``render``'s. With
    ``mesh`` (a group of ``parallel/mesh.py``) the view is
    ``render_multichip``'s, banded by ``raster.band_assign`` and compacted
    to ``raster.visible_capacity``, and the largest band and shard size
    the grown buffers."""
    attempts = 0
    while True:
        common = dict(backend=raster.backend, dup_capacity=raster.dup_capacity,
                      max_per_tile=raster.max_per_tile, chunk=raster.chunk,
                      **raster_lever_kwargs(raster), **kwargs)
        if mesh is None:
            out = render(camera, params, bg, **common)
        else:
            # the multi-GPU render streams f32 features, as the JAX
            # package's does: it takes no bf16_features
            from .parallel.render_mc import render_multichip
            common.pop("bf16_features")
            out = render_multichip(
                params, camera, bg, mesh, band_assign=raster.band_assign,
                visible_capacity=max(raster.visible_capacity, 0), **common)
        if not bool(out.overflow):
            return out, raster
        banded = out.band_duplicates is not None
        nd = int(out.band_duplicates.max() if banded else out.num_duplicates)
        ml = int(out.max_tile_len)
        changes = overflow_changes(
            raster.dup_capacity, raster.max_per_tile, nd, ml,
            raster.visible_capacity if banded else 0,
            int(out.band_visible.max()) if banded else 0)
        if not changes or attempts == 3:
            print(f"[gs_tpu_torch] WARNING: {label} overflowed at "
                  f"dup_capacity {raster.dup_capacity}, max_per_tile "
                  f"{raster.max_per_tile} (num_duplicates {nd}, max_tile_len "
                  f"{ml}); entries were dropped", flush=True)
            return out, raster
        print(f"[gs_tpu_torch] {label} overflowed its buffers "
              f"(num_duplicates {nd}, max_tile_len {ml}); rendering again "
              f"with {changes}", flush=True)
        raster = dataclasses.replace(raster, **changes)
        attempts += 1


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
                     exact_cull: bool = False, row_map=None,
                     row_cumown=None, col0_map=None,
                     col1_map=None) -> RenderOutput:
    """Render projected Gaussians. ``row_map``/``row_cumown`` (an
    ascending row list and its exclusive owned-row prefix; the JAX
    package's ``row_phase``/``row_stride`` band is the map
    phase + j*stride), with ``col0_map``/``col1_map``
    (per local row, the owned tile columns): render one band of a
    multi-GPU frame into ``height`` = the band's rows x 16, coordinates
    global (``parallel/render_mc.py``). ``bf16_features`` streams the
    colours and invdepth through the tile sort as bf16 pairs on the
    ``cuda`` backend (``ops/rasterize.py``); ``binned`` and ``depthwise``
    ignore it, as the JAX package's oracles do."""
    backend = resolve_backend(backend)
    rows = dict(row_map=row_map, row_cumown=row_cumown, col0_map=col0_map,
                col1_map=col1_map)
    dev = proj.depth.device
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nv = zero_i
    if backend == "depthwise":
        if row_map is not None:
            raise ValueError("the depthwise oracle renders full frames only")
        image, invd, finalT = rasterize_depthwise(
            proj, width, height, bg, tile_x=TILE_X, tile_y=TILE_Y, chunk=chunk)
        nd, ml, ov = zero_i, zero_i, torch.zeros((), dtype=torch.bool, device=dev)
    elif backend == "binned":
        bins = bin_gaussians(proj, width, height, TILE_X, TILE_Y, dup_capacity,
                             **rows)
        image, invd, finalT = rasterize_binned(
            proj, bins, width, height, bg, tile_x=TILE_X, tile_y=TILE_Y,
            max_per_tile=max_per_tile, chunk=chunk, row_map=row_map)
        nd = bins.num_duplicates
        ml = torch.max(bins.tile_end - bins.tile_start)
        ov = bins.overflow | (ml > max_per_tile)
        nv = bins.num_valid
    else:
        image, invd, finalT, nd, ml, ov, nv = rasterize(
            proj, width, height, bg, max_per_tile=max_per_tile,
            dup_capacity=dup_capacity, exact_cull=exact_cull,
            bf16_features=bf16_features, **rows)
    return RenderOutput(image=image, invdepth=invd, final_T=finalT,
                        radii=proj.radius, visibility=proj.visible,
                        num_duplicates=nd, max_tile_len=ml, overflow=ov,
                        num_valid=nv)
