"""Training-state Gaussian model — port of
``gs_tpu/models/gaussian_model.py``: initial Gaussians from a point cloud,
the training state, per-group Adam, the exposure optimizer and the
densification statistics.

Tensors are padded to a capacity with an ``alive`` mask, as in the JAX
package (dead slots: tiny scale, near-zero opacity, identity rotation).
Semantics as there (ref: scene/gaussian_model.py:160-191, 431-433;
train.py:157-175): Adam with eps 1e-15, per-group learning rates,
f_rest = feature_lr / 20, one step count shared by all groups; sparse Adam
updates only the rows visible in the last render. Updates are functional:
each returns a new state, as the JAX package's do.

Density control (``densify_and_prune``, ``reset_opacity``, ``compact``,
``grow_capacity``) belongs to the training loop and is not ported yet.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import OptimizationConfig
from ..core.gaussians import GaussianParams, inverse_sigmoid
from ..core.sh import rgb2sh
from ..core.spatial import mean_sq_dist_to_3nn
from ..utils.schedules import expon_lr

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15      # ref: gaussian_model.py:170
EXP_ADAM_EPS = 1e-8   # torch default for the exposure optimizer


class TrainState(NamedTuple):
    params: GaussianParams
    alive: torch.Tensor          # [C] bool
    m: GaussianParams            # Adam first moment
    v: GaussianParams            # Adam second moment
    step: torch.Tensor           # [] int32 shared Adam step
    grad_accum: torch.Tensor     # [C] sum of ||mean2D grad||
    denom: torch.Tensor          # [C] visibility counts
    max_radii2D: torch.Tensor    # [C] int32
    exposure: torch.Tensor       # [num_images, 3, 4]
    exp_m: torch.Tensor
    exp_v: torch.Tensor
    exp_step: torch.Tensor       # [] int32

    @property
    def capacity(self) -> int:
        return self.params.capacity

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)


def _zeros_like_params(p: GaussianParams) -> GaussianParams:
    return GaussianParams(*[torch.zeros_like(t) for t in p])


def init_state(params: GaussianParams, alive: torch.Tensor,
               num_images: int) -> TrainState:
    c = params.capacity
    dev = params.xyz.device
    eye = torch.cat([torch.eye(3, device=dev), torch.zeros((3, 1), device=dev)],
                    dim=1)
    exposure = eye[None].repeat(max(num_images, 1), 1, 1)
    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    return TrainState(
        params=params, alive=alive,
        m=_zeros_like_params(params), v=_zeros_like_params(params),
        step=zero_i,
        grad_accum=torch.zeros((c,), device=dev),
        denom=torch.zeros((c,), device=dev),
        max_radii2D=torch.zeros((c,), dtype=torch.int32, device=dev),
        exposure=exposure,
        exp_m=torch.zeros_like(exposure), exp_v=torch.zeros_like(exposure),
        exp_step=zero_i.clone(),
    )


def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: Optional[int] = None, *,
                    device="cuda") -> tuple[GaussianParams, torch.Tensor]:
    """Initial Gaussians from a point cloud (ref: scene/gaussian_model.py:130-153)."""
    n = points.shape[0]
    if capacity is None:
        capacity = max(1 << int(math.ceil(math.log2(max(n, 1) * 2))), 1024)
    rest_dim = (sh_degree + 1) ** 2 - 1

    xyz = torch.tensor(np.asarray(points, np.float32), device=device)
    dist2 = mean_sq_dist_to_3nn(xyz)
    log_scale = torch.log(torch.sqrt(dist2))[:, None].repeat(1, 3)
    sh_dc = rgb2sh(torch.tensor(np.asarray(colors, np.float32),
                                device=device))[:, None, :]
    quat = torch.tensor([1.0, 0, 0, 0], device=device).repeat(n, 1)
    logit_op = inverse_sigmoid(0.1 * torch.ones((n, 1), device=device))

    def pad(x, fill=0.0):
        out = torch.full((capacity,) + tuple(x.shape[1:]), fill,
                         dtype=torch.float32, device=device)
        out[:n] = x
        return out

    quat_p = pad(quat)
    quat_p[n:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(xyz),
        sh_dc=pad(sh_dc),
        sh_rest=torch.zeros((capacity, rest_dim, 3), device=device),
        log_scale=pad(log_scale, -10.0),
        quat=quat_p,
        logit_opacity=pad(logit_op, -10.0),
    )
    alive = torch.arange(capacity, device=device) < n
    return params, alive


# ---------------------------------------------------------------- Adam

def group_lrs(opt: OptimizationConfig, step,
              spatial_lr_scale: float) -> GaussianParams:
    """Per-parameter-group learning rates as floats (ref:
    gaussian_model.py:160-191)."""
    xyz_lr = expon_lr(step,
                      opt.position_lr_init * spatial_lr_scale,
                      opt.position_lr_final * spatial_lr_scale,
                      lr_delay_mult=opt.position_lr_delay_mult,
                      max_steps=opt.position_lr_max_steps)
    return GaussianParams(
        xyz=xyz_lr,
        sh_dc=float(np.float32(opt.feature_lr)),
        sh_rest=float(np.float32(opt.feature_lr / 20.0)),
        log_scale=float(np.float32(opt.scaling_lr)),
        quat=float(np.float32(opt.rotation_lr)),
        logit_opacity=float(np.float32(opt.opacity_lr)),
    )


def adam_update(state: TrainState, grads: GaussianParams,
                lrs: GaussianParams,
                visible_mask: Optional[torch.Tensor] = None) -> TrainState:
    """Dense Adam, or sparse (row-masked) when ``visible_mask`` is given:
    rows outside the mask keep their parameters and moments."""
    step = state.step + 1
    t = step.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** t
    bc2 = 1.0 - ADAM_B2 ** t

    def masked(new, old):
        if visible_mask is None:
            return new
        mask = visible_mask.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(mask, new, old)

    ms, vs, ps = [], [], []
    for g, m, v, p, lr in zip(grads, state.m, state.v, state.params, lrs):
        m_new = masked(ADAM_B1 * m + (1 - ADAM_B1) * g, m)
        v_new = masked(ADAM_B2 * v + (1 - ADAM_B2) * g * g, v)
        ms.append(m_new)
        vs.append(v_new)
        ps.append(masked(
            p - lr * (m_new / bc1) / (torch.sqrt(v_new / bc2) + ADAM_EPS), p))
    return state._replace(params=GaussianParams(*ps), m=GaussianParams(*ms),
                          v=GaussianParams(*vs), step=step)


def exposure_update(state: TrainState, exp_grad: torch.Tensor,
                    opt: OptimizationConfig, iteration) -> TrainState:
    lr = expon_lr(iteration, opt.exposure_lr_init, opt.exposure_lr_final,
                  lr_delay_steps=opt.exposure_lr_delay_steps,
                  lr_delay_mult=opt.exposure_lr_delay_mult,
                  max_steps=opt.iterations)
    step = state.exp_step + 1
    t = step.to(torch.float32)
    m = ADAM_B1 * state.exp_m + (1 - ADAM_B1) * exp_grad
    v = ADAM_B2 * state.exp_v + (1 - ADAM_B2) * exp_grad ** 2
    p = state.exposure - lr * (m / (1 - ADAM_B1 ** t)) / (
        torch.sqrt(v / (1 - ADAM_B2 ** t)) + EXP_ADAM_EPS)
    return state._replace(exposure=p, exp_m=m, exp_v=v, exp_step=step)


# ----------------------------------------------------- density statistics

def add_densification_stats(state: TrainState, mean2d_grad: torch.Tensor,
                            visibility: torch.Tensor, width: int, height: int,
                            radii: torch.Tensor) -> TrainState:
    """Accumulate ||dL/d mean2D|| in the reference's ndc-half-res units.

    ``mean2d_grad`` is in pixels; the reference's screenspace tensor carries
    gradients scaled by (0.5*W, 0.5*H) (ref: gaussian_model.py:431-433 +
    the CUDA ddelx_dx factor).
    """
    scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                         device=mean2d_grad.device)
    norm = torch.linalg.vector_norm(mean2d_grad * scale, dim=-1)
    return state._replace(
        grad_accum=state.grad_accum + torch.where(visibility, norm, 0.0),
        denom=state.denom + visibility.to(torch.float32),
        max_radii2D=torch.where(visibility,
                                torch.maximum(state.max_radii2D, radii),
                                state.max_radii2D),
    )
