"""The training step — port of ``gs_tpu/train/step.py::make_train_step``:
render, L1 + SSIM (+ optional depth-L1) loss, backward, densification
statistics, learning-rate schedule, (sparse) Adam, exposure update (ref:
train.py:87-179). With a ``mesh`` (a group of ``parallel/mesh.py``) the
state is this process's shards and the render is
``parallel/render_mc.py::render_multichip``; the loss is the same on every
process, and each updates its own shards. With ``packed`` the state is a
``models/packed_state.py::PackedState``: the preprocess reads the [R, C]
block through one autograd Function and Adam is one pass over the block
(``core/packed.py``); the semantics are the tree layout's.

The step has a device-indexed core, as the JAX package's ``step_core``:
the camera index and the iteration are 0-d device tensors, the camera is
picked by ``index_select``, the SH degree (+1 per 1000 iterations, ref:
train.py:91-93) and the densification gate are computed on the device,
and the learning rates and the depth-L1 weight come in as a schedule row
(:func:`schedule_table`, each value ``utils/schedules.py::expon_lr``'s
float32). So the core reads nothing back and uploads nothing, and a CUDA
graph can capture it (``train/graph.py``), under a mesh too: the banded
render's collectives enqueue on the stream and read nothing back
(``parallel/mesh.py``). ``make_train_step`` returns
the per-step wrapper of that core, which takes the iteration and the
camera index as Python ints and uploads them with the step's schedule row.

The SH ramp masks the inactive coefficients to zero and evaluates the full
basis, as the JAX step does, so the masked coefficients get exact zero
gradients: ``mask_sh_rest`` on the tree layout, ``preprocess_packed``'s
``mask_degree`` on the packed one (inside the kernel pair on CUDA). The
random background (``opt.random_background``) is drawn from the
``generator`` the caller passes, or given outright as ``bg``.
Nothing in the step reads the device back: the metrics are 0-d tensors.

The core stamps where its stages begin (``utils/spans.py``): ``preprocess``
(one device; the banded render stamps its own), ``loss``, ``update``, and,
in the backward, ``loss_bwd`` and ``preprocess_bwd`` by marks on the loss
and on the screen-space means (the render marks ``raster_bwd``). Its
callers open the step with ``step`` (the per-step wrapper here, the graphed
runners' ``step_body``) and close it with ``end``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig, RasterConfig
from ..core.camera import CameraBatch
from ..core.gaussians import GaussianParams, mask_sh_rest
from ..core.packed import layout as packed_layout
from ..core.project import preprocess, preprocess_packed
from ..models.gaussian_model import (TrainState, adam_update,
                                     add_densification_stats, exposure_lr,
                                     exposure_update, group_lrs)
from ..models.packed_state import adam_update_packed, group_lr_rows
from ..ops.losses import l1_loss
from ..ops.ssim import ssim
from ..parallel.render_mc import render_multichip
from ..render import render_projected
from ..utils import spans
from ..utils.schedules import expon_lr


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    l1: torch.Tensor
    ssim: torch.Tensor
    depth_l1: torch.Tensor
    num_duplicates: torch.Tensor
    max_tile_len: torch.Tensor
    overflow: torch.Tensor
    n_visible: torch.Tensor
    # multi-GPU only: the largest shard's visible count (what
    # visible_capacity must hold) and the largest band's num_duplicates
    # (what the per-band dup_capacity must hold)
    max_band_visible: Optional[torch.Tensor] = None
    max_band_duplicates: Optional[torch.Tensor] = None


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """image' = E[:, :3]^T-mixed colors + offset (ref: gaussian_renderer/__init__.py:111-114)."""
    return (torch.einsum('chw,ck->khw', image, exposure[:3, :3])
            + exposure[:3, 3, None, None])


def schedule_table(opt: OptimizationConfig, spatial_lr_scale: float,
                   iterations) -> np.ndarray:
    """[K, 3] float32, one row per iteration: the xyz learning rate
    (``group_lrs``), the exposure rate (``exposure_lr``) and the depth-L1
    weight, each the float32 ``expon_lr`` gives the eager step."""
    return np.array([(group_lrs(opt, i, spatial_lr_scale).xyz,
                      exposure_lr(opt, i),
                      expon_lr(i, opt.depth_l1_weight_init,
                               opt.depth_l1_weight_final,
                               max_steps=opt.iterations))
                     for i in iterations], np.float32).reshape(-1, 3)


def make_train_step(opt: OptimizationConfig, model_cfg: ModelConfig,
                    pipe: PipelineConfig, raster: RasterConfig,
                    cams: CameraBatch, spatial_lr_scale: float,
                    max_sh_degree: int, mesh=None, packed: bool = False):
    """Returns ``step(state, cam_idx, gt_image, alpha_mask=None,
    invdepth_gt=None, depth_mask=None, depth_ok=0.0, iteration=1, *,
    bg=None, generator=None) -> (state, StepMetrics)``, on the cameras'
    device. ``bg`` overrides the background; otherwise it is white or black
    (``model_cfg.white_background``), or drawn from ``generator`` under
    ``opt.random_background``. ``mesh``: render through the multi-GPU path
    with the state sharded over that group (``raster``'s
    ``visible_capacity`` and ``band_assign``; ``bf16_features`` is not
    read there, as in the JAX package's mesh branches). ``packed``: the
    state is a ``PackedState``.

    ``step.core(state, cam_idx, iteration, sched, gt_image, alpha_mask,
    invdepth_gt, depth_mask, depth_ok, bg=None, *, valid=None,
    inplace=False)`` is the device-indexed step: ``cam_idx`` and
    ``iteration`` 0-d int64 tensors, ``sched`` a [3] row of
    :func:`schedule_table`, ``depth_ok`` a 0-d float32 tensor (read only
    with ``invdepth_gt``), ``bg`` None for the static background. ``valid``
    (0-d bool) gates every update, as the JAX core's; ``inplace`` writes
    the new state into the given one (``models/gaussian_model.py``).
    ``step.schedule(iterations)`` is :func:`schedule_table` for this
    step's configuration; ``step.mesh`` is ``mesh``."""
    width, height = cams.width, cams.height
    dev = cams.device
    use_sparse = opt.optimizer_type == "sparse_adam"
    use_exposure = model_cfg.train_test_exp
    bg_static = (torch.ones(3, device=dev) if model_cfg.white_background
                 else torch.zeros(3, device=dev))
    render_kw = dict(backend=raster.backend, dup_capacity=raster.dup_capacity,
                     max_per_tile=raster.max_per_tile, chunk=raster.chunk,
                     exact_cull=raster.exact_cull)
    mesh_kw = dict(render_kw, antialiasing=pipe.antialiasing,
                   active_sh_degree=max_sh_degree,
                   visible_capacity=max(raster.visible_capacity, 0),
                   band_assign=raster.band_assign)
    lay = packed_layout(max_sh_degree)
    # the constants of every step, on the device once
    stats_scale = torch.tensor([0.5 * width, 0.5 * height],
                               dtype=torch.float32, device=dev)
    lrs_fixed = group_lrs(opt, 0, spatial_lr_scale)
    if packed:
        lr_fixed = group_lr_rows(lay, opt, 0, spatial_lr_scale, device=dev)
        xyz_rows = (torch.arange(lay.rows, device=dev) < lay.xyz + 3)[:, None]

    def core(state, cam_idx: torch.Tensor, iteration: torch.Tensor,
             sched: torch.Tensor, gt_image: torch.Tensor,
             alpha_mask: Optional[torch.Tensor] = None,
             invdepth_gt: Optional[torch.Tensor] = None,
             depth_mask: Optional[torch.Tensor] = None,
             depth_ok: Optional[torch.Tensor] = None,
             bg: Optional[torch.Tensor] = None, *,
             valid: Optional[torch.Tensor] = None, inplace: bool = False):
        index = cam_idx.reshape(1)
        cam = cams.select_index(index)
        active_sh_degree = torch.clamp(iteration // 1000, max=max_sh_degree)
        if bg is None:
            bg = bg_static

        if packed:
            # the SH ramp is preprocess_packed's mask_degree
            leaves = [state.packed.detach().requires_grad_(True)]
            params = leaves[0]
        else:
            leaves = [t.detach().requires_grad_(True) for t in state.params]
            params = mask_sh_rest(GaussianParams(*leaves), active_sh_degree)
        tap = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)
        exposure_row = state.exposure.index_select(0, index)[0].detach(
            ).requires_grad_(use_exposure)

        if mesh is not None:
            # the stages of the banded render are stamped inside it
            out = render_multichip(
                params, cam, bg, mesh, alive=state.alive, mean2d_tap=tap,
                packed_sh_degree=max_sh_degree if packed else None,
                mask_degree=active_sh_degree if packed else None, **mesh_kw)
        else:
            spans.stage("preprocess", dev)
            if packed:
                proj = preprocess_packed(
                    params, cam, sh_degree=max_sh_degree,
                    active_sh_degree=max_sh_degree,
                    antialiasing=pipe.antialiasing, alive=state.alive,
                    mask_degree=active_sh_degree)
            else:
                proj = preprocess(params, cam, active_sh_degree=max_sh_degree,
                                  antialiasing=pipe.antialiasing,
                                  alive=state.alive)
            proj = proj._replace(mean2d=spans.mark(
                "preprocess_bwd", proj.mean2d + tap))
            out = render_projected(proj, width, height, bg,
                                   bf16_features=raster.bf16_features,
                                   **render_kw)
        spans.stage("loss", dev)
        image = out.image
        if use_exposure:
            image = apply_exposure(image, exposure_row)
        if alpha_mask is not None:
            image = image * alpha_mask
        ll1 = l1_loss(image, gt_image)
        ssim_v = ssim(image, gt_image)
        loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_v)

        # depth regularization (ref: train.py:124-135)
        if invdepth_gt is not None:
            dl1_pure = torch.mean(torch.abs((out.invdepth[0] - invdepth_gt)
                                            * depth_mask))
            dl1 = sched[2] * dl1_pure * depth_ok
            loss = loss + dl1
        else:
            dl1 = torch.zeros((), device=dev)

        inputs = leaves + [tap] + ([exposure_row] if use_exposure else [])
        grads = torch.autograd.grad(spans.mark("loss_bwd", loss), inputs,
                                    allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        tap_grad = grads[len(leaves)]

        spans.stage("update", dev)
        with torch.no_grad():
            # densification statistics, while densification runs
            # (ref: train.py:157-160)
            stats_gate = out.visibility & (iteration < opt.densify_until_iter)
            state = add_densification_stats(
                state, tap_grad, stats_gate, width, height, out.radii,
                scale=stats_scale, valid=valid, inplace=inplace)
            visible = out.visibility if use_sparse else None
            if packed:
                # the xyz rows take the scheduled rate, by selection
                lr = torch.where(xyz_rows, sched[0], lr_fixed)
                state = adam_update_packed(state, grads[0], lr, visible,
                                           valid=valid, inplace=inplace)
            else:
                state = adam_update(
                    state, GaussianParams(*grads[:len(leaves)]),
                    lrs_fixed._replace(xyz=sched[0]), visible,
                    valid=valid, inplace=inplace)
            if use_exposure:
                full = torch.zeros_like(state.exposure).index_copy_(
                    0, index, grads[-1][None])
                state = exposure_update(state, full, opt, iteration,
                                        valid=valid, lr=sched[1],
                                        inplace=inplace)
            banded = out.band_visible is not None
            metrics = StepMetrics(
                loss=loss.detach(), l1=ll1.detach(), ssim=ssim_v.detach(),
                depth_l1=dl1.detach(), num_duplicates=out.num_duplicates,
                max_tile_len=out.max_tile_len, overflow=out.overflow,
                n_visible=(out.band_visible.sum() if banded
                           else torch.sum(out.visibility)),
                max_band_visible=(out.band_visible.max() if banded
                                  else None),
                max_band_duplicates=(out.band_duplicates.max() if banded
                                     else None))
        return state, metrics

    def upload(value, dtype) -> torch.Tensor:
        if isinstance(value, torch.Tensor):
            return value.to(device=dev, dtype=dtype)
        return torch.tensor(value, dtype=dtype).to(dev, non_blocking=True)

    def step(state: TrainState, cam_idx: int, gt_image: torch.Tensor,
             alpha_mask: Optional[torch.Tensor] = None,
             invdepth_gt: Optional[torch.Tensor] = None,
             depth_mask: Optional[torch.Tensor] = None,
             depth_ok=0.0, iteration: int = 1, *,
             bg: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        if bg is None and opt.random_background:
            bg = torch.rand(3, generator=generator, device=dev)
        spans.stage("step", dev)
        sched = torch.from_numpy(schedule(iteration)[0]).to(
            dev, non_blocking=True)
        out = core(state, upload(cam_idx, torch.int64),
                   upload(iteration, torch.int64), sched, gt_image,
                   alpha_mask, invdepth_gt, depth_mask,
                   upload(depth_ok, torch.float32), bg)
        spans.stage("end", dev)
        return out

    def schedule(iterations) -> np.ndarray:
        return schedule_table(opt, spatial_lr_scale,
                              np.atleast_1d(iterations))

    step.core = core
    step.schedule = schedule
    step.device = dev
    step.random_background = opt.random_background
    step.mesh = mesh
    return step
