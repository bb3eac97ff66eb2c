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
second render at grown buffers when it is set. Given a :class:`ViewGraph`
it renders through it: on CUDA one captured CUDA graph replayed per view,
as the JAX package jits its per-view render (``gs_tpu/train/loop.py:
661-701``, ``gs_tpu/apps/render.py:70-85``); on the CPU the same body,
eagerly. ``render()`` itself stays eager, as the JAX package's is.

The view's stage stamps (``utils/spans.py``): ``frame`` and ``end`` around
the view graph's body, ``preprocess`` in ``render``, ``binning`` in
``render_projected``, ``raster`` before K1 (``ops/rasterize.py``). Host
spans: ``view`` around ``render_grown`` (a new frame each), with a view
graph's ``view.load``, ``view.replay`` and ``view.copy_out``, and
``view.overflow_check``, inside.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from .core.camera import Camera
from .core.gaussians import GaussianParams, mask_sh_rest
from .core.packed import degree_from_rows, unpack_params
from .core.project import Projected, preprocess
from .ops.binning import F32_EXACT, bin_gaussians
from .ops.rasterize import rasterize
from .ops.rasterize_plain import rasterize_binned, rasterize_depthwise
from .utils import spans
from .utils.cuda_graphs import GraphCache, capture, replay

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
                 raster, *, label: str = "view", mesh=None,
                 graph: Optional["ViewGraph"] = None, **kwargs):
    """``render`` with ``raster``'s backend and buffers, read back once: a
    view that overflowed them renders again with buffers sized from its
    ``num_duplicates`` and ``max_tile_len`` (``overflow_changes``), and a
    view that overflows even at ``MAX_DUP_CAPACITY`` is reported. Returns
    (output, the RasterConfig it rendered with); ``raster`` itself is
    never changed. Without overflow the output is ``render``'s. With
    ``mesh`` (a group of ``parallel/mesh.py``) the view is
    ``render_multichip``'s, banded by ``raster.band_assign`` and compacted
    to ``raster.visible_capacity``, and the largest band and shard size
    the grown buffers. With ``graph`` every render is that
    :class:`ViewGraph`'s (under ``mesh`` one made with it), and ``kwargs``
    are its call's (``params`` may then be a packed block and
    ``sh_degree`` masks the SH ramp)."""
    if graph is not None and graph.mesh is not mesh:
        raise ValueError("the view graph was made for another group")
    with spans.span("view", frame=True):
        attempts = 0
        while True:
            common = dict(backend=raster.backend,
                          dup_capacity=raster.dup_capacity,
                          max_per_tile=raster.max_per_tile, chunk=raster.chunk,
                          **raster_lever_kwargs(raster), **kwargs)
            if mesh is not None:
                # the multi-GPU render streams f32 features, as the JAX
                # package's does: it takes no bf16_features
                common.pop("bf16_features")
                common.update(band_assign=raster.band_assign,
                              visible_capacity=max(raster.visible_capacity, 0))
            if graph is not None:
                out = graph(camera, params, bg, **common)
            elif mesh is None:
                out = render(camera, params, bg, **common)
            else:
                from .parallel.render_mc import render_multichip
                out = render_multichip(params, camera, bg, mesh, **common)
            with spans.span("view.overflow_check"):
                overflowed = bool(out.overflow)
            if not overflowed:
                return out, raster
            banded = out.band_duplicates is not None
            nd = int(out.band_duplicates.max() if banded
                     else out.num_duplicates)
            ml = int(out.max_tile_len)
            changes = overflow_changes(
                raster.dup_capacity, raster.max_per_tile, nd, ml,
                raster.visible_capacity if banded else 0,
                int(out.band_visible.max()) if banded else 0)
            if not changes or attempts == 3:
                print(f"[gs_tpu_torch] WARNING: {label} overflowed at "
                      f"dup_capacity {raster.dup_capacity}, max_per_tile "
                      f"{raster.max_per_tile} (num_duplicates {nd}, "
                      f"max_tile_len {ml}); entries were dropped", flush=True)
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
    spans.stage("preprocess", camera.device)
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
    spans.stage("binning", dev)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    nv = zero_i
    if backend == "depthwise":
        if row_map is not None:
            raise ValueError("the depthwise oracle renders full frames only")
        spans.stage("raster", dev)
        image, invd, finalT = rasterize_depthwise(
            proj, width, height, bg, tile_x=TILE_X, tile_y=TILE_Y, chunk=chunk)
        nd, ml, ov = zero_i, zero_i, torch.zeros((), dtype=torch.bool, device=dev)
    elif backend == "binned":
        bins = bin_gaussians(proj, width, height, TILE_X, TILE_Y, dup_capacity,
                             **rows)
        spans.stage("raster", dev)
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


# the camera's tensors, a view graph's static inputs
CAMERA_TENSORS = ("world_view", "full_proj", "camera_center", "tan_fovx",
                  "tan_fovy")


class _View:
    """One captured view: its static inputs, graph and outputs."""

    def __init__(self, camera: Camera, bg: torch.Tensor, masked: bool):
        dev = camera.device
        self.camera = dataclasses.replace(camera, **{
            k: getattr(camera, k).clone() for k in CAMERA_TENSORS})
        self.bg = bg.clone()
        self.sh_degree = (torch.zeros((), dtype=torch.int64, device=dev)
                          if masked else None)
        self.scaling_modifier = torch.ones((), dtype=torch.float32,
                                           device=dev)
        self.graph = None
        self.counts: dict = {}
        self.out: Optional[RenderOutput] = None

    def load(self, camera: Camera, bg: torch.Tensor, sh_degree,
             scaling_modifier):
        for k in CAMERA_TENSORS:
            getattr(self.camera, k).copy_(getattr(camera, k))
        self.bg.copy_(bg)
        if self.sh_degree is not None:
            self.sh_degree.fill_(int(sh_degree))
        self.scaling_modifier.fill_(float(scaling_modifier))


# the views a ViewGraph keeps captured: the least recently used goes first
MAX_VIEWS = 4


class ViewGraph(GraphCache):
    """The no-grad view as a CUDA graph: the port of the JAX package's
    jitted per-view render (the trainer's ``_eval_render``, the render
    CLI's ``render_view``).

    A call renders ``params`` (a ``GaussianParams``, or a packed [R, C]
    block, unpacked inside the view) with ``render()``'s arguments, or,
    made with a ``mesh`` (a group of ``parallel/mesh.py``), the local
    shards with ``render_multichip``'s (``band_assign`` and
    ``visible_capacity`` among them; no ``scaling_modifier``). On
    CUDA it replays the graph captured for the call's key and returns a
    copy of its outputs; on the CPU it runs the same body eagerly. The
    graph's static inputs are the camera's tensors, the background, the SH
    degree ``sh_degree`` (coefficients above it masked to zero, as the
    train step's ramp; None: no mask) and ``scaling_modifier``, each
    copied in before the replay, so none is frozen into a capture. Its key
    is everything else that shapes the work: the resolution, the state's
    shapes (the capacity), the buffers (``dup_capacity``,
    ``max_per_tile``, ``chunk``), the backend, the pipeline switches and
    the raster levers (the JAX trainer's ``_eval_render`` keys its cache on
    the background, the capacity and the buffers, ``gs_tpu/train/
    loop.py:668-669``). The graphs read the state's tensors themselves: a
    call with other tensors (a state replaced by a densify outside the
    training graph, a capacity growth, another model) releases every graph
    and captures again; the graphs hold only weak references to them, so
    they keep no state alive.

    At most ``max_views`` views stay captured: a new key beyond them
    releases the least recently used (a viewer whose window is resized, a
    dataset of many image sizes, would otherwise keep a graph for each).
    Every graph allocates from one memory pool, so the view's buffers are
    held once, not once per key: that is safe because the graphs never run
    at once and each call copies its outputs out before the next replay
    (another key's replay may write over them). ``captures`` records each
    capture's resolution, capacity, ``dup_capacity``, ms, peak allocation
    (``pool_peak_bytes``) and what it added to the memory the card
    reserves (``pool_growth_bytes``: none where the shared pool had room).

    Under a mesh every process renders every view, banded, and the graph
    holds the render's collectives: the key adds the group's size, every
    rank captures at the same call (what decides a capture is what the
    ranks share: the resolution, the shapes, the buffers) with the group's
    ``capture_error_mode``, the ranks agree (``every``) that the capture
    succeeded, and a ``ProcessGroup`` releases the view graphs before it
    is destroyed (``close``)."""

    def __init__(self, max_views: int = MAX_VIEWS, mesh=None):
        super().__init__()
        self.max_views = max(int(max_views), 1)
        self.mesh = mesh
        self.reads: tuple = ()       # weak references to the state's tensors
        self.captures: list = []     # {width, height, capacity, ms, pool}

    @property
    def views(self) -> OrderedDict:
        """The captured views by key, the oldest first."""
        return self.entries

    def _reads_from(self, leaves) -> bool:
        return len(leaves) == len(self.reads) and all(
            r() is t for r, t in zip(self.reads, leaves))

    def __call__(self, camera: Camera, params, bg: torch.Tensor, *,
                 alive: torch.Tensor, sh_degree=None,
                 scaling_modifier: float = 1.0, **kwargs) -> RenderOutput:
        if self.mesh is not None and scaling_modifier != 1.0:
            raise ValueError("scaling_modifier is not supported under a "
                             "mesh")
        with spans.span("view.load"):
            leaves = ([params] if isinstance(params, torch.Tensor)
                      else list(params)) + [alive]
            if not self._reads_from(leaves):
                self.release()
                self.reads = tuple(weakref.ref(t) for t in leaves)
            key = (camera.width, camera.height, sh_degree is None,
                   None if self.mesh is None else self.mesh.size,
                   tuple((tuple(t.shape), t.dtype) for t in leaves),
                   tuple(sorted(kwargs.items())))
            v = self.lookup(key)
            if v is not None:
                v.load(camera, bg, sh_degree, scaling_modifier)
        if v is None:
            v = _View(camera, bg, sh_degree is not None)
            v.load(camera, bg, sh_degree, scaling_modifier)
            if camera.device.type == "cuda":
                self._capture(v, params, alive, kwargs)
            self.insert(key, v, self.max_views)
        with spans.span("view.replay"):
            if v.graph is not None:
                replay(v.graph, v.counts)
            else:
                v.out = self._body(v, params, alive, kwargs)
        with spans.span("view.copy_out"):
            return RenderOutput(*[x.clone() if isinstance(x, torch.Tensor)
                                  else x for x in v.out])

    def _body(self, v: _View, params, alive, kwargs) -> RenderOutput:
        """The view: its ``frame`` stamp opens the stages that the render
        stamps, and ``end`` closes them (``utils/spans.py``)."""
        dev = v.camera.device
        spans.stage("frame", dev)
        if isinstance(params, torch.Tensor):
            params = unpack_params(params, degree_from_rows(params.shape[0]))
        if v.sh_degree is not None:
            params = mask_sh_rest(params, v.sh_degree)
        with torch.no_grad():
            if self.mesh is not None:
                from .parallel.render_mc import render_multichip
                out = render_multichip(params, v.camera, v.bg, self.mesh,
                                       alive=alive, **kwargs)
            else:
                out = render(v.camera, params, v.bg, alive=alive,
                             scaling_modifier=v.scaling_modifier, **kwargs)
        spans.stage("end", dev)
        return out

    def _capture(self, v: _View, params, alive, kwargs):
        def body():
            v.out = self._body(v, params, alive, kwargs)

        cap = capture(v.camera.device,
                      lambda: self._body(v, params, alive, kwargs), body,
                      "view", mesh=self.mesh, owner=self,
                      pool=self.pool_handle())
        v.graph, v.counts = cap.graph, cap.counts
        ms = 1e3 * (time.perf_counter() - cap.start)
        capacity = alive.shape[0]
        self.captures.append(dict(
            width=v.camera.width, height=v.camera.height, capacity=capacity,
            dup_capacity=kwargs.get("dup_capacity"), ms=ms,
            pool_peak_bytes=cap.pool_peak_bytes,
            pool_growth_bytes=cap.reserved_growth_bytes))
        print(f"[gs_tpu_torch] captured the {v.camera.width}x"
              f"{v.camera.height} view at capacity {capacity}, dup_capacity "
              f"{kwargs.get('dup_capacity')} in {ms:.1f} ms (graph pool peak "
              f"{cap.pool_peak_bytes} bytes)", flush=True)
