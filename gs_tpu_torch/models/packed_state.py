"""Training state over the channel-major packed parameter block — port of
``gs_tpu/models/packed_state.py``.

The hot training path (gradients, Adam moments, updates) runs on ONE
[R, C] float32 tensor per state tensor (``core/packed.py`` says why). Cold
operations (densify and prune every 100 iterations, opacity reset every
3000, checkpoint and PLY IO, eval renders) convert to the tree-layout
:class:`TrainState` and reuse its semantics (``models/gaussian_model.py``),
so the behaviour is tested once. ``PackedState.params`` unpacks on access,
so cold call sites (PLY save, the viewer, histograms) work unchanged.

Every function returns a new state and writes into none of its inputs, as
the tree layout's do (the trainer's overflow replay keeps old states), but
where ``inplace`` asks it to (the graph replays).

Adam's pass over the block is one hand-written kernel on a CUDA device
(``csrc/adam.cu``, ``ops/adam.py::adam_packed``, which counts its
launches); its twin, :func:`adam_update_packed_plain`, runs elsewhere and
is what the tests hold the kernel to, bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import OptimizationConfig
from ..core.gaussians import GaussianParams, inverse_sigmoid
from ..core.packed import (PackedLayout, degree_from_rows, layout, lr_rows,
                           pack_params, unpack_params)
from ..ops.adam import adam_packed
from .gaussian_model import (ADAM_B1, ADAM_B2, ADAM_EPS, TrainState, _count,
                             _put, compact, densify_and_prune, grow_capacity,
                             group_lrs)


class PackedState(NamedTuple):
    packed: torch.Tensor        # [R, C] parameters (channel-major)
    alive: torch.Tensor         # [C] bool
    m: torch.Tensor             # [R, C] Adam first moment
    v: torch.Tensor             # [R, C] Adam second moment
    step: torch.Tensor          # [] int32 shared Adam step
    grad_accum: torch.Tensor    # [C]
    denom: torch.Tensor         # [C]
    max_radii2D: torch.Tensor   # [C] int32
    exposure: torch.Tensor      # [num_images, 3, 4]
    exp_m: torch.Tensor
    exp_v: torch.Tensor
    exp_step: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.packed.shape[1]

    @property
    def num_alive(self) -> torch.Tensor:
        return torch.sum(self.alive)

    @property
    def sh_degree(self) -> int:
        return degree_from_rows(self.packed.shape[0])

    @property
    def params(self) -> GaussianParams:
        return unpack_params(self.packed, self.sh_degree)


def pack_state(ts: TrainState) -> PackedState:
    return PackedState(
        packed=pack_params(ts.params), alive=ts.alive,
        m=pack_params(ts.m), v=pack_params(ts.v),
        step=ts.step, grad_accum=ts.grad_accum, denom=ts.denom,
        max_radii2D=ts.max_radii2D, exposure=ts.exposure,
        exp_m=ts.exp_m, exp_v=ts.exp_v, exp_step=ts.exp_step)


def unpack_state(ps: PackedState) -> TrainState:
    d = ps.sh_degree
    return TrainState(
        params=unpack_params(ps.packed, d), alive=ps.alive,
        m=unpack_params(ps.m, d), v=unpack_params(ps.v, d),
        step=ps.step, grad_accum=ps.grad_accum, denom=ps.denom,
        max_radii2D=ps.max_radii2D, exposure=ps.exposure,
        exp_m=ps.exp_m, exp_v=ps.exp_v, exp_step=ps.exp_step)


# ---------------------------------------------------------------- hot path

def group_lr_rows(lay: PackedLayout, opt: OptimizationConfig, step,
                  spatial_lr_scale: float, device="cuda") -> torch.Tensor:
    """[R, 1] per-row learning rates: the packed form of
    ``gaussian_model.group_lrs`` (ref: gaussian_model.py:160-191)."""
    return lr_rows(lay, *group_lrs(opt, step, spatial_lr_scale),
                   device=device)


def adam_update_packed(ps: PackedState, grad: torch.Tensor,
                       lr: torch.Tensor,
                       visible_mask: Optional[torch.Tensor] = None,
                       inplace: bool = False) -> PackedState:
    """Dense Adam, or column-masked sparse Adam with ``visible_mask`` [C],
    as one elementwise pass over the block. The math and constants of
    ``gaussian_model.adam_update`` (eps 1e-15, ref: gaussian_model.py:170;
    sparse masking ref: train.py:173-175), so the two agree bitwise.
    ``inplace``: as ``gaussian_model.adam_update``. ``lr``: the [R, 1] row
    rates.

    On a CUDA device the pass is the kernel of ``csrc/adam.cu``
    (``ops/adam.py::adam_packed``); elsewhere its twin,
    :func:`adam_update_packed_plain`."""
    if ps.packed.device.type != "cuda":
        return adam_update_packed_plain(ps, grad, lr, visible_mask, inplace)
    step, bc1, bc2 = _bias_corrections(ps.step, inplace)
    p, m, v = adam_packed(ps.packed, ps.m, ps.v, grad, lr, bc1, bc2,
                          visible_mask, inplace)
    return ps._replace(packed=p, m=m, v=v, step=step)


def _bias_corrections(step: torch.Tensor, inplace: bool):
    """The advanced step count and Adam's 1 - B1^t and 1 - B2^t, 0-d
    tensors on the step's device."""
    step = _count(step, inplace)
    t = step.to(torch.float32)
    return step, 1.0 - ADAM_B1 ** t, 1.0 - ADAM_B2 ** t


def adam_update_packed_plain(ps: PackedState, grad: torch.Tensor,
                             lr: torch.Tensor,
                             visible_mask: Optional[torch.Tensor] = None,
                             inplace: bool = False) -> PackedState:
    """The kernel's twin: :func:`adam_update_packed` as PyTorch elementwise
    passes, on any device."""
    step, bc1, bc2 = _bias_corrections(ps.step, inplace)
    gate = None if visible_mask is None else visible_mask[None, :]
    m = _put(gate, ps.m, inplace, torch.add, ADAM_B1 * ps.m,
             (1 - ADAM_B1) * grad)
    v = _put(gate, ps.v, inplace, torch.add, ADAM_B2 * ps.v,
             (1 - ADAM_B2) * grad * grad)
    p = _put(gate, ps.packed, inplace, torch.sub, ps.packed,
             lr * (m / bc1) / (torch.sqrt(v / bc2) + ADAM_EPS))
    return ps._replace(packed=p, m=m, v=v, step=step)


def reset_opacity_packed(ps: PackedState) -> PackedState:
    """Clamp opacity to <= 0.01 and zero its Adam rows (ref:
    gaussian_model.py:226-229, :274-287), in the JAX package's row
    arithmetic: every row is blended with the opacity row's new value."""
    lay = layout(ps.sh_degree)
    row = torch.arange(ps.packed.shape[0], device=ps.packed.device) \
        == lay.logit_opacity
    rowf = row.to(ps.packed.dtype)[:, None]
    op = torch.sigmoid(ps.packed[lay.logit_opacity])
    new_logit = inverse_sigmoid(torch.clamp_max(op, 0.01))
    packed = ps.packed * (1 - rowf) + rowf * new_logit[None, :]
    return ps._replace(packed=packed,
                       m=ps.m * (1 - rowf), v=ps.v * (1 - rowf))


# ------------------------------------------------- cold-path delegations

def densify_and_prune_packed(ps: PackedState,
                             noise: Optional[torch.Tensor] = None, **kw):
    """Unpack, the tree layout's ``densify_and_prune``, pack again (every
    densification interval, so the transposes are amortised)."""
    ts, info = densify_and_prune(unpack_state(ps), noise, **kw)
    return pack_state(ts), info


def grow_capacity_packed(ps: PackedState, new_capacity: int) -> PackedState:
    return pack_state(grow_capacity(unpack_state(ps), new_capacity))


def compact_packed(ps: PackedState,
                   capacity: Optional[int] = None) -> PackedState:
    return pack_state(compact(unpack_state(ps), capacity))
