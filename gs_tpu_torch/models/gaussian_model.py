"""Training-state Gaussian model — port of
``gs_tpu/models/gaussian_model.py``: initial Gaussians from a point cloud,
the training state, per-group Adam, the exposure optimizer, the
densification statistics and density control.

Tensors are padded to a capacity with an ``alive`` mask, as in the JAX
package (dead slots: tiny scale, near-zero opacity, identity rotation).
Semantics as there (ref: scene/gaussian_model.py:160-191, 431-433;
train.py:157-175): Adam with eps 1e-15, per-group learning rates,
f_rest = feature_lr / 20, one step count shared by all groups; sparse Adam
updates only the rows visible in the last render. Updates are functional:
each returns a new state, as the JAX package's do.

Density control (ref: scene/gaussian_model.py:367-433, train.py:157-167)
works at a fixed capacity, as in the JAX package: clones and split
children go into free slots, pruned rows die, and the capacity changes only
through ``compact`` and ``grow_capacity``, never past ``MAX_CAPACITY``.
Every function returns a new state and writes into none of its inputs, so a
caller may keep the old state (the trainer's overflow replay does). The split noise is an argument: JAX's and
torch's generators differ, so the tests feed both packages the same draws.

The per-step updates (Adam, the exposure optimizer, the densification
statistics) take two more arguments, as the JAX package's do for its
block scan. ``valid``, a bool tensor, makes the update an exact no-op when
False, step counters included (the masked tail steps of a scan bucket,
``train/graph.py``); None is the ungated update, bit for bit. ``inplace``
writes each result into the state's own tensor with the last operation
that computes it (``out=``), where the default allocates a new one: the
CUDA-graph step (``train/graph.py``) updates its static state so, and
nowhere else is it used. The values are the same either way.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import OptimizationConfig
from ..core.gaussians import (GaussianParams, get_opacity, get_scaling,
                              inverse_sigmoid, quat_to_rotmat)
from ..core.sh import rgb2sh
from ..core.spatial import mean_sq_dist_to_3nn
from ..utils.schedules import expon_lr

ADAM_B1 = 0.9
ADAM_B2 = 0.999
ADAM_EPS = 1e-15      # ref: gaussian_model.py:170
EXP_ADAM_EPS = 1e-8   # torch default for the exposure optimizer
# the largest capacity a state takes: the largest multiple of 1024 below
# 2^24, the binning's limit on the Gaussian count (ops/binning.py)
MAX_CAPACITY = (1 << 24) - 1024


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


def map_state(fn, state: TrainState) -> TrainState:
    """``fn`` applied to every tensor of the state (the JAX package's
    ``jax.tree.map`` over a TrainState)."""
    return TrainState(*[GaussianParams(*[fn(t) for t in x])
                        if isinstance(x, GaussianParams) else fn(x)
                        for x in state])


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


def default_capacity(n: int) -> int:
    """create_from_pcd's capacity for ``n`` points: the power of two at or
    above 2n (at least 1024), capped at ``MAX_CAPACITY``."""
    if n > MAX_CAPACITY:
        raise ValueError(
            f"a point cloud of {n} points is larger than the largest "
            f"capacity the binning can address ({MAX_CAPACITY}, the largest "
            f"multiple of 1024 below 2^24); subsample it first")
    return min(max(1 << int(math.ceil(math.log2(max(n, 1) * 2))), 1024),
               MAX_CAPACITY)


def create_from_pcd(points: np.ndarray, colors: np.ndarray, sh_degree: int,
                    capacity: Optional[int] = None, *,
                    device="cuda") -> tuple[GaussianParams, torch.Tensor]:
    """Initial Gaussians from a point cloud (ref: scene/gaussian_model.py:130-153)."""
    n = points.shape[0]
    if capacity is None:
        capacity = default_capacity(n)
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


def _gate(mask: Optional[torch.Tensor], valid: Optional[torch.Tensor]):
    """The row mask and the step's ``valid`` flag combined (None: none)."""
    if valid is None:
        return mask
    return valid if mask is None else mask & valid


def _put(gate, old: torch.Tensor, inplace: bool, op, *args) -> torch.Tensor:
    """``op(*args)`` where ``gate`` holds (everywhere when None), ``old``
    elsewhere; written into ``old`` when ``inplace``."""
    out = old if inplace else None
    if gate is None:
        return op(*args, out=out)
    return torch.where(gate, op(*args), old, out=out)


def _count(step: torch.Tensor, valid, inplace: bool) -> torch.Tensor:
    """A step counter advanced by one (by ``valid`` when given)."""
    inc = 1 if valid is None else valid.to(step.dtype)
    return torch.add(step, inc, out=step if inplace else None)


def adam_update(state: TrainState, grads: GaussianParams,
                lrs: GaussianParams,
                visible_mask: Optional[torch.Tensor] = None,
                valid: Optional[torch.Tensor] = None,
                inplace: bool = False) -> TrainState:
    """Dense Adam, or sparse (row-masked) when ``visible_mask`` is given:
    rows outside the mask keep their parameters and moments. ``valid``
    False: no update at all, the step count included."""
    step = _count(state.step, valid, inplace)
    t = step.to(torch.float32)
    bc1 = 1.0 - ADAM_B1 ** t
    bc2 = 1.0 - ADAM_B2 ** t

    ms, vs, ps = [], [], []
    for g, m, v, p, lr in zip(grads, state.m, state.v, state.params, lrs):
        gate = _gate(None if visible_mask is None else visible_mask.reshape(
            (-1,) + (1,) * (p.dim() - 1)), valid)
        m_new = _put(gate, m, inplace, torch.add, ADAM_B1 * m,
                     (1 - ADAM_B1) * g)
        v_new = _put(gate, v, inplace, torch.add, ADAM_B2 * v,
                     (1 - ADAM_B2) * g * g)
        ms.append(m_new)
        vs.append(v_new)
        ps.append(_put(gate, p, inplace, torch.sub, p, lr * (m_new / bc1) / (
            torch.sqrt(v_new / bc2) + ADAM_EPS)))
    return state._replace(params=GaussianParams(*ps), m=GaussianParams(*ms),
                          v=GaussianParams(*vs), step=step)


def exposure_lr(opt: OptimizationConfig, iteration) -> float:
    """The exposure optimizer's rate at ``iteration`` (ref: train.py's
    exposure scheduler)."""
    return expon_lr(iteration, opt.exposure_lr_init, opt.exposure_lr_final,
                    lr_delay_steps=opt.exposure_lr_delay_steps,
                    lr_delay_mult=opt.exposure_lr_delay_mult,
                    max_steps=opt.iterations)


def exposure_update(state: TrainState, exp_grad: torch.Tensor,
                    opt: OptimizationConfig, iteration,
                    valid: Optional[torch.Tensor] = None, *, lr=None,
                    inplace: bool = False) -> TrainState:
    """One Adam step of the per-image exposures. ``lr``: the rate (a 0-d
    tensor from the step's schedule row); None computes it from
    ``iteration``."""
    if lr is None:
        lr = exposure_lr(opt, iteration)
    step = _count(state.exp_step, valid, inplace)
    t = step.to(torch.float32)
    m = _put(valid, state.exp_m, inplace, torch.add, ADAM_B1 * state.exp_m,
             (1 - ADAM_B1) * exp_grad)
    v = _put(valid, state.exp_v, inplace, torch.add, ADAM_B2 * state.exp_v,
             (1 - ADAM_B2) * exp_grad ** 2)
    p = _put(valid, state.exposure, inplace, torch.sub, state.exposure,
             lr * (m / (1 - ADAM_B1 ** t)) / (
                 torch.sqrt(v / (1 - ADAM_B2 ** t)) + EXP_ADAM_EPS))
    return state._replace(exposure=p, exp_m=m, exp_v=v, exp_step=step)


# ----------------------------------------------------- density statistics

def add_densification_stats(state: TrainState, mean2d_grad: torch.Tensor,
                            visibility: torch.Tensor, width: int, height: int,
                            radii: torch.Tensor, *,
                            scale: Optional[torch.Tensor] = None,
                            valid: Optional[torch.Tensor] = None,
                            inplace: bool = False) -> TrainState:
    """Accumulate ||dL/d mean2D|| in the reference's ndc-half-res units.

    ``mean2d_grad`` is in pixels; the reference's screenspace tensor carries
    gradients scaled by (0.5*W, 0.5*H) (ref: gaussian_model.py:431-433 +
    the CUDA ddelx_dx factor). ``scale``: that [2] factor on the device,
    made once by the caller (None makes it here).
    """
    if scale is None:
        scale = torch.tensor([0.5 * width, 0.5 * height], dtype=torch.float32,
                             device=mean2d_grad.device)
    visibility = _gate(visibility, valid)
    norm = torch.linalg.vector_norm(mean2d_grad * scale, dim=-1)

    def out(x):
        return x if inplace else None

    return state._replace(
        grad_accum=torch.add(state.grad_accum,
                             torch.where(visibility, norm, 0.0),
                             out=out(state.grad_accum)),
        denom=torch.add(state.denom, visibility.to(torch.float32),
                        out=out(state.denom)),
        max_radii2D=torch.where(visibility,
                                torch.maximum(state.max_radii2D, radii),
                                state.max_radii2D,
                                out=out(state.max_radii2D)),
    )


# ----------------------------------------------------- density control

class DensifyInfo(NamedTuple):
    n_cloned: torch.Tensor
    n_split: torch.Tensor
    n_pruned: torch.Tensor
    n_dropped: torch.Tensor   # new Gaussians that found no free slot
    n_alive: torch.Tensor


def _nonzero_padded(mask: torch.Tensor, fill: int) -> torch.Tensor:
    """Indices of ``mask``'s true entries in order, padded with ``fill`` to
    the mask's length (``jnp.nonzero(mask, size=c, fill_value=fill)``).
    Nothing is read back, so a CUDA graph can capture it: each true entry's
    index goes to its place in the running count, each false entry's to a
    spare last slot, which is then dropped."""
    c = mask.shape[0]
    dest = torch.where(mask, torch.cumsum(mask, 0) - 1, c)
    out = torch.full((c + 1,), fill, dtype=torch.int64, device=mask.device)
    out.scatter_(0, dest, torch.arange(c, device=mask.device))
    return out[:c]


def densify_and_prune(state: TrainState, noise: Optional[torch.Tensor] = None,
                      *, grad_threshold: float, min_opacity: float,
                      extent: float, percent_dense: float,
                      use_size_threshold,
                      generator: Optional[torch.Generator] = None,
                      ) -> tuple[TrainState, DensifyInfo]:
    """One densify/clone/split/prune pass at fixed capacity.

    ``noise`` [C, 3] is the standard-normal draw that places split children
    (ref: :376-378); without it one is drawn from ``generator``. The
    reference enables size pruning only after the first opacity reset
    (train.py:163): ``use_size_threshold``, a bool or a 0-d bool tensor
    (JAX traces it as a ``jnp.bool_``), used only in the masks. Given the
    noise, the pass reads nothing back to the host, so a CUDA graph can
    capture it (``train/graph.py::DensityGraph``).
    """
    p = state.params
    c = p.capacity
    dev = p.xyz.device
    alive = state.alive
    if noise is None:
        noise = torch.randn((c, 3), generator=generator, device=dev)

    grads = state.grad_accum / state.denom
    grads = torch.where(torch.isnan(grads), 0.0, grads)  # ref: gaussian_model.py:413-414

    scaling = get_scaling(p)
    max_scale = torch.max(scaling, dim=1).values
    opacity = get_opacity(p)[:, 0]

    grad_ok = grads >= grad_threshold
    small = max_scale <= percent_dense * extent
    clone_mask = alive & grad_ok & small                 # ref: :393-397
    split_mask = alive & grad_ok & ~small                # ref: :367-374

    # prune condition for existing rows. The view-space radii term reads the
    # post-postfix (zeroed) max_radii2D in the reference, so it is always
    # False — reproduced deliberately, as in the JAX package.
    ws_prune = max_scale > 0.1 * extent
    use_st = use_size_threshold          # never read on the host
    prune_cond = (opacity < min_opacity) | (use_st & ws_prune)

    keep = alive & ~prune_cond & ~split_mask
    n_pruned = torch.sum(alive & prune_cond & ~split_mask)

    # --- candidate lists -------------------------------------------------
    clone_create = clone_mask & ~prune_cond
    split_create = split_mask
    n_clone = torch.sum(clone_create)
    n_split = torch.sum(split_create)

    clone_src_list = _nonzero_padded(clone_create, 0)
    split_src_list = _nonzero_padded(split_create, 0)
    free_slots = _nonzero_padded(~keep, c)
    n_free = torch.sum(~keep)

    r = torch.arange(c, device=dev)
    is_clone = r < n_clone
    is_split_a = (r >= n_clone) & (r < n_clone + n_split)
    is_split_b = (r >= n_clone + n_split) & (r < n_clone + 2 * n_split)
    src = torch.where(
        is_clone, clone_src_list[r],
        torch.where(is_split_a,
                    split_src_list[torch.clamp(r - n_clone, 0, c - 1)],
                    split_src_list[torch.clamp(r - n_clone - n_split, 0, c - 1)]))
    is_split_child = is_split_a | is_split_b
    valid_new = is_clone | is_split_child

    n_new = n_clone + 2 * n_split
    n_dropped = torch.clamp_min(n_new - n_free, 0)

    # --- new values ------------------------------------------------------
    src_xyz = p.xyz[src]
    src_scale = scaling[src]
    R = quat_to_rotmat(p.quat[src])
    offset = torch.einsum('nij,nj->ni', R, noise * src_scale)
    new_xyz = torch.where(is_split_child[:, None], src_xyz + offset, src_xyz)
    child_log_scale = torch.log(src_scale / (0.8 * 2))   # ref: :381
    new_log_scale = torch.where(is_split_child[:, None],
                                child_log_scale, p.log_scale[src])

    # children may themselves violate the prune conditions (the reference
    # prunes right after creating them, ref: :420-425)
    child_max_scale = max_scale[src] / (0.8 * 2)
    child_prune = (opacity[src] < min_opacity) | (
        use_st & (child_max_scale > 0.1 * extent))
    valid_new = valid_new & ~(is_split_child & child_prune)

    # slot c is a spare row that takes every new row without a free slot
    target = torch.where(valid_new, free_slots[r], c)

    def place(arr, new_rows):
        out = torch.cat([arr, arr[:1]])
        out[target] = new_rows
        return out[:c]

    new_params = GaussianParams(
        xyz=place(p.xyz, new_xyz),
        sh_dc=place(p.sh_dc, p.sh_dc[src]),
        sh_rest=place(p.sh_rest, p.sh_rest[src]),
        log_scale=place(p.log_scale, new_log_scale),
        quat=place(p.quat, p.quat[src]),
        logit_opacity=place(p.logit_opacity, p.logit_opacity[src]),
    )
    new_alive = place(keep, torch.ones_like(keep))
    # optimizer state of new slots is zeroed (ref: :324-344); slots that were
    # pruned and not refilled also reset so stale moments never leak back in
    changed = new_alive != keep
    reset_rows = changed | (~new_alive & alive)

    def reset(x):
        mask = reset_rows.reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(mask, 0.0, x)

    info = DensifyInfo(n_cloned=n_clone, n_split=n_split, n_pruned=n_pruned,
                       n_dropped=n_dropped, n_alive=torch.sum(new_alive))
    new_state = state._replace(
        params=new_params, alive=new_alive,
        m=GaussianParams(*[reset(t) for t in state.m]),
        v=GaussianParams(*[reset(t) for t in state.v]),
        grad_accum=torch.zeros_like(state.grad_accum),
        denom=torch.zeros_like(state.denom),
        max_radii2D=torch.zeros_like(state.max_radii2D),
    )
    return new_state, info


def reset_opacity(state: TrainState) -> TrainState:
    """Clamp opacity to <= 0.01 and reset its Adam state
    (ref: gaussian_model.py:226-229, :274-287)."""
    op = get_opacity(state.params)
    new_logit = inverse_sigmoid(torch.clamp_max(op, 0.01))
    return state._replace(
        params=state.params._replace(logit_opacity=new_logit),
        m=state.m._replace(logit_opacity=torch.zeros_like(state.m.logit_opacity)),
        v=state.v._replace(logit_opacity=torch.zeros_like(state.v.logit_opacity)),
    )


# -------------------------------------------------- capacity management

def _dead_slot_fills(state: TrainState, n: int) -> TrainState:
    """Rows from ``n`` on render as nothing: identity rotation, log scale
    and logit opacity -10."""
    p = state.params
    quat, log_scale, logit_op = (p.quat.clone(), p.log_scale.clone(),
                                 p.logit_opacity.clone())
    quat[n:, 0] = 1.0
    log_scale[n:] = -10.0
    logit_op[n:] = -10.0
    return state._replace(params=p._replace(quat=quat, log_scale=log_scale,
                                            logit_opacity=logit_op))


def compact(state: TrainState, capacity: Optional[int] = None) -> TrainState:
    """Gather alive rows to the front and optionally shrink capacity.

    Host-side: reads the alive mask back. Used after heavy pruning or
    before serving, so dead slots stop costing preprocess work and memory.
    Order of alive gaussians is preserved; the capacity rule is
    ``create_from_pcd``'s.
    """
    idx = np.flatnonzero(state.alive.cpu().numpy())
    n = len(idx)
    if capacity is None:
        capacity = max(1 << int(math.ceil(math.log2(max(n, 1) * 2))), 1024)
    if capacity < n:
        raise ValueError(f"capacity {capacity} < {n} alive gaussians")
    c = state.capacity
    dev = state.alive.device
    take = torch.tensor(np.concatenate([idx, np.zeros(capacity - n, np.int64)]),
                        device=dev)
    keep = torch.arange(capacity, device=dev) < n

    def pick(x):
        if x.dim() >= 1 and x.shape[0] == c:
            out = x[take]
            mask = keep.reshape((-1,) + (1,) * (out.dim() - 1))
            return torch.where(mask, out, torch.zeros_like(out))
        return x

    new = map_state(pick, state)._replace(alive=keep)
    return _dead_slot_fills(new, n)


def grow_capacity(state: TrainState, new_capacity: int) -> TrainState:
    """Host-side re-pad of every [C, ...] tensor to ``new_capacity``; the new
    rows are dead slots."""
    c = state.capacity
    if not c <= new_capacity <= MAX_CAPACITY:
        raise ValueError(f"new capacity {new_capacity} outside "
                         f"[{c}, MAX_CAPACITY = {MAX_CAPACITY}]")

    def pad(x):
        if x.dim() >= 1 and x.shape[0] == c:
            out = x.new_zeros((new_capacity,) + tuple(x.shape[1:]))
            out[:c] = x
            return out
        return x

    return _dead_slot_fills(map_state(pad, state), c)
