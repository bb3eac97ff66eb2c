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

The JAX package compiles this into one function and picks the camera by a
traced index; here the step runs eagerly, so the iteration and the camera
index are plain Python ints and the schedules are evaluated on the host.
The SH degree ramp (+1 per 1000 iterations, ref: train.py:91-93) masks the
inactive coefficients to zero and evaluates the full basis, as the JAX
step does, so the masked coefficients get exact zero gradients.

The random background (``opt.random_background``) is drawn from the
``generator`` the caller passes, or given outright as ``bg``. Nothing in the
step reads the device back: the metrics are 0-d tensors.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import ModelConfig, OptimizationConfig, PipelineConfig, RasterConfig
from ..core.camera import CameraBatch
from ..core.gaussians import GaussianParams
from ..core.packed import layout as packed_layout, mask_sh_rows
from ..core.project import preprocess, preprocess_packed
from ..models.gaussian_model import (TrainState, adam_update,
                                     add_densification_stats, exposure_update,
                                     group_lrs)
from ..models.packed_state import adam_update_packed, group_lr_rows
from ..ops.losses import l1_loss
from ..ops.ssim import ssim
from ..parallel.render_mc import render_multichip
from ..render import render_projected
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


def mask_sh_rest(params: GaussianParams, active_sh_degree: int) -> GaussianParams:
    """Zero coefficients above the active degree (the SH ramp)."""
    rest_dim = params.sh_rest.shape[1]
    k = torch.arange(1, rest_dim + 1, device=params.sh_rest.device)
    keep = k < (active_sh_degree + 1) ** 2   # index in the full basis (DC is 0)
    mask = keep.to(params.sh_rest.dtype)[None, :, None]
    return params._replace(sh_rest=params.sh_rest * mask)


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """image' = E[:, :3]^T-mixed colors + offset (ref: gaussian_renderer/__init__.py:111-114)."""
    return (torch.einsum('chw,ck->khw', image, exposure[:3, :3])
            + exposure[:3, 3, None, None])


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
    state is a ``PackedState``."""
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

    def step(state: TrainState, cam_idx: int, gt_image: torch.Tensor,
             alpha_mask: Optional[torch.Tensor] = None,
             invdepth_gt: Optional[torch.Tensor] = None,
             depth_mask: Optional[torch.Tensor] = None,
             depth_ok=0.0, iteration: int = 1, *,
             bg: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        cam = cams.select(cam_idx)
        active_sh_degree = min(iteration // 1000, max_sh_degree)
        if bg is None:
            bg = (torch.rand(3, generator=generator, device=dev)
                  if opt.random_background else bg_static)

        if packed:
            leaves = [state.packed.detach().requires_grad_(True)]
            masked = mask_sh_rows(leaves[0], lay, active_sh_degree)
        else:
            leaves = [t.detach().requires_grad_(True) for t in state.params]
            masked = mask_sh_rest(GaussianParams(*leaves), active_sh_degree)
        tap = torch.zeros((state.capacity, 2), device=dev, requires_grad=True)
        exposure_row = state.exposure[cam_idx].detach().requires_grad_(
            use_exposure)

        if mesh is not None:
            out = render_multichip(
                masked, cam, bg, mesh, alive=state.alive, mean2d_tap=tap,
                packed_sh_degree=max_sh_degree if packed else None,
                **mesh_kw)
        else:
            if packed:
                proj = preprocess_packed(
                    masked, cam, sh_degree=max_sh_degree,
                    active_sh_degree=max_sh_degree,
                    antialiasing=pipe.antialiasing, alive=state.alive)
            else:
                proj = preprocess(masked, cam, active_sh_degree=max_sh_degree,
                                  antialiasing=pipe.antialiasing,
                                  alive=state.alive)
            proj = proj._replace(mean2d=proj.mean2d + tap)
            out = render_projected(proj, width, height, bg,
                                   bf16_features=raster.bf16_features,
                                   **render_kw)
        image = out.image
        if use_exposure:
            image = apply_exposure(image, exposure_row)
        if alpha_mask is not None:
            image = image * alpha_mask
        ll1 = l1_loss(image, gt_image)
        ssim_v = ssim(image, gt_image)
        loss = (1.0 - opt.lambda_dssim) * ll1 + opt.lambda_dssim * (1.0 - ssim_v)

        # depth regularization (ref: train.py:124-135)
        dw = expon_lr(iteration, opt.depth_l1_weight_init,
                      opt.depth_l1_weight_final, max_steps=opt.iterations)
        if invdepth_gt is not None:
            dl1_pure = torch.mean(torch.abs((out.invdepth[0] - invdepth_gt)
                                            * depth_mask))
            dl1 = dw * dl1_pure * depth_ok
            loss = loss + dl1
        else:
            dl1 = torch.zeros((), device=dev)

        inputs = leaves + [tap] + ([exposure_row] if use_exposure else [])
        grads = torch.autograd.grad(loss, inputs, allow_unused=True)
        grads = [torch.zeros_like(x) if g is None else g
                 for x, g in zip(inputs, grads)]
        tap_grad = grads[len(leaves)]

        with torch.no_grad():
            # densification statistics, while densification runs
            # (ref: train.py:157-160)
            stats_gate = out.visibility & (iteration < opt.densify_until_iter)
            state = add_densification_stats(state, tap_grad, stats_gate,
                                            width, height, out.radii)
            visible = out.visibility if use_sparse else None
            # a profiler trace shows the update under this name
            with torch.profiler.record_function("gs_tpu_torch.adam"):
                if packed:
                    lr = group_lr_rows(lay, opt, iteration, spatial_lr_scale,
                                       device=dev)
                    state = adam_update_packed(state, grads[0], lr, visible)
                else:
                    lrs = group_lrs(opt, iteration, spatial_lr_scale)
                    state = adam_update(
                        state, GaussianParams(*grads[:len(leaves)]), lrs,
                        visible)
            if use_exposure:
                full = torch.zeros_like(state.exposure)
                full[cam_idx] = grads[-1]
                state = exposure_update(state, full, opt, iteration)
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

    return step
