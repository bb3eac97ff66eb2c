"""Channel-major packed parameter block — port of ``gs_tpu/core/packed.py``.

Training state (parameters, gradients, Adam moments) lives as ONE [R, C]
float32 tensor: row = scalar parameter channel, column = Gaussian. The JAX
package chose it for the TPU's (8, 128) tiling, where the [C, 3] and
[C, 15, 3] leaves pay lane padding on every read and write. On the GPU the
same layout pays off through autograd: the preprocess reads its 59 channels
as rows, and :class:`_ReadRows` hands the whole block's gradient back as one
stack, where indexing a leaf's columns gives one zero-filled leaf-sized
tensor and one add per channel (``SelectBackward0``). Adam is then one
elementwise pass over one block, where the tree layout runs six groups.

Row layout for SH degree d (rest = (d+1)^2 - 1):
    0..2                xyz
    3..5                sh_dc (r, g, b)
    6 .. 6+3*rest-1     sh_rest band k color c at 6 + 3k + c
    then                log_scale (3), quat (4), logit_opacity (1)
    pad to a multiple of 8 rows

Conversions to and from :class:`GaussianParams` are transposes, used at the
cold boundaries (init, densify, checkpoint and PLY IO, eval renders), never
in the per-step hot path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .gaussians import GaussianParams


class PackedLayout(NamedTuple):
    """Static row indices for one SH degree."""
    sh_degree: int
    rest: int        # number of sh_rest bands
    xyz: int         # first xyz row (always 0)
    sh_dc: int
    sh_rest: int
    log_scale: int
    quat: int
    logit_opacity: int
    n_channels: int  # real channels
    rows: int        # padded row count (multiple of 8)


def layout(sh_degree: int) -> PackedLayout:
    rest = (sh_degree + 1) ** 2 - 1
    xyz = 0
    sh_dc = 3
    sh_rest = 6
    log_scale = sh_rest + 3 * rest
    quat = log_scale + 3
    logit_opacity = quat + 4
    n = logit_opacity + 1
    rows = -(-n // 8) * 8
    return PackedLayout(sh_degree, rest, xyz, sh_dc, sh_rest, log_scale,
                        quat, logit_opacity, n, rows)


def pack_params(p: GaussianParams) -> torch.Tensor:
    """GaussianParams -> [R, C] packed block (a transpose; cold path)."""
    lay = layout(p.sh_degree)
    c = p.capacity
    flat = torch.cat([p.xyz, p.sh_dc.reshape(c, 3),
                      p.sh_rest.reshape(c, 3 * lay.rest),
                      p.log_scale, p.quat, p.logit_opacity], dim=1)
    out = flat.new_zeros((lay.rows, c))
    out[:lay.n_channels] = flat.T
    return out


def unpack_params(packed: torch.Tensor, sh_degree: int) -> GaussianParams:
    """[R, C] -> GaussianParams of contiguous leaves (a transpose; cold
    path)."""
    lay = layout(sh_degree)
    c = packed.shape[1]
    flat = packed[:lay.n_channels].T                     # [C, n]

    def cols(start, n, *shape):
        return flat[:, start:start + n].reshape(c, *shape).contiguous()

    return GaussianParams(
        xyz=cols(lay.xyz, 3, 3),
        sh_dc=cols(lay.sh_dc, 3, 1, 3),
        sh_rest=cols(lay.sh_rest, 3 * lay.rest, lay.rest, 3),
        log_scale=cols(lay.log_scale, 3, 3),
        quat=cols(lay.quat, 4, 4),
        logit_opacity=cols(lay.logit_opacity, 1, 1),
    )


# ------------------------------------------------------------- row access

class _ReadRows(torch.autograd.Function):
    """Rows [start, start + n) of the block as n [C] tensors (views). The
    backward, ``gs_tpu/core/packed.py::read_rows``'s custom VJP, writes
    the n cotangents into one [R, C] tensor with one stack, zeros in the
    other rows; rows that got no cotangent arrive as zeros."""

    @staticmethod
    def forward(ctx, packed, start: int, n: int):
        ctx.start, ctx.n, ctx.rows = start, n, packed.shape[0]
        return tuple(packed[start:start + n].unbind(0))

    @staticmethod
    def backward(ctx, *cts):
        start, n = ctx.start, ctx.n
        out = cts[0].new_empty((ctx.rows, cts[0].shape[0]))
        out[:start].zero_()
        out[start + n:].zero_()
        torch.stack(cts, dim=0, out=out[start:start + n])
        return out, None, None


def read_rows(packed: torch.Tensor, start: int, n: int):
    """Differentiable read of rows [start, start + n) as a tuple of [C]
    tensors; the gradient reaches ``packed`` as one [R, C] stack."""
    return _ReadRows.apply(packed, start, n)


def all_channels(packed: torch.Tensor, sh_degree: int) -> dict:
    """One differentiable read of every real channel row: a dict of flat
    [C] channels x, y, z, sh_dc (3), sh_rest (3 * rest), ls (3), quat (4),
    lop."""
    lay = layout(sh_degree)
    rows = read_rows(packed, 0, lay.n_channels)
    r = lay.sh_rest
    return dict(
        x=rows[0], y=rows[1], z=rows[2],
        sh_dc=rows[lay.sh_dc:lay.sh_dc + 3],
        sh_rest=rows[r:r + 3 * lay.rest],
        ls=rows[lay.log_scale:lay.log_scale + 3],
        quat=rows[lay.quat:lay.quat + 4],
        lop=rows[lay.logit_opacity],
    )


# ------------------------------------------------------- per-row metadata

def lr_rows(lay: PackedLayout, xyz_lr, sh_dc_lr, sh_rest_lr, log_scale_lr,
            quat_lr, logit_opacity_lr, device="cuda") -> torch.Tensor:
    """[R, 1] float32 per-row learning rates from the six group rates
    (zero on the padding rows)."""
    out = np.zeros((lay.rows, 1), np.float32)
    for start, n, v in ((lay.xyz, 3, xyz_lr), (lay.sh_dc, 3, sh_dc_lr),
                        (lay.sh_rest, 3 * lay.rest, sh_rest_lr),
                        (lay.log_scale, 3, log_scale_lr),
                        (lay.quat, 4, quat_lr),
                        (lay.logit_opacity, 1, logit_opacity_lr)):
        out[start:start + n] = v
    return torch.from_numpy(out).to(device)


def sh_band_index(lay: PackedLayout) -> np.ndarray:
    """[R] int32: the full-basis index of each sh_rest row (0 for every
    other row), for the SH-degree ramp mask."""
    idx = np.zeros((lay.rows,), np.int32)
    for k in range(lay.rest):
        for cch in range(3):
            idx[lay.sh_rest + 3 * k + cch] = k + 1
    return idx


def mask_sh_rows(packed: torch.Tensor, lay: PackedLayout,
                 active_sh_degree: int) -> torch.Tensor:
    """Zero the sh_rest rows above the active degree (the SH ramp):
    the packed form of ``train/step.py::mask_sh_rest``."""
    keep = sh_band_index(lay) < (active_sh_degree + 1) ** 2
    return packed * torch.from_numpy(
        keep.astype(np.float32)[:, None]).to(packed.device)
