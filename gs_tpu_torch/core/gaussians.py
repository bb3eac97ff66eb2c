"""Gaussian parameters and activations — port of ``gs_tpu/core/gaussians.py``.

The parameter store mirrors the reference's six parameter groups
(ref: scene/gaussian_model.py:53-58) as capacity-padded tensors with the same
field names and ``[C, ...]`` layouts as ``gs_tpu.core.gaussians``; an
``alive`` mask marks the real rows.

Activations (ref: scene/gaussian_model.py:31-47):
  scaling  = exp(log_scale)
  opacity  = sigmoid(logit)
  rotation = L2-normalized quaternion (w, x, y, z)
  cov3d    = R S S^T R^T packed to the 6 upper-triangle entries
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class GaussianParams(NamedTuple):
    """Parameters, all tensors padded to a capacity C, on one device."""
    xyz: torch.Tensor        # [C, 3]
    sh_dc: torch.Tensor      # [C, 1, 3]  DC SH coefficients (reference f_dc layout)
    sh_rest: torch.Tensor    # [C, (d+1)^2-1, 3]
    log_scale: torch.Tensor  # [C, 3]
    quat: torch.Tensor       # [C, 4]  (w, x, y, z) unnormalized
    logit_opacity: torch.Tensor  # [C, 1]

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def sh_degree(self) -> int:
        return int(round((self.sh_rest.shape[1] + 1) ** 0.5)) - 1


def mask_sh_rest(params: GaussianParams, active_sh_degree) -> GaussianParams:
    """Zero coefficients above the active degree (the SH ramp); the degree
    is an int or a 0-d tensor."""
    rest_dim = params.sh_rest.shape[1]
    k = torch.arange(1, rest_dim + 1, device=params.sh_rest.device)
    keep = k < (active_sh_degree + 1) ** 2   # index in the full basis (DC is 0)
    mask = keep.to(params.sh_rest.dtype)[None, :, None]
    return params._replace(sh_rest=params.sh_rest * mask)


def inverse_sigmoid(x):
    # ref: utils/general_utils.py:17-18
    return torch.log(x / (1.0 - x))


def get_scaling(p: GaussianParams) -> torch.Tensor:
    return torch.exp(p.log_scale)


def get_opacity(p: GaussianParams) -> torch.Tensor:
    return torch.sigmoid(p.logit_opacity)


def get_rotation(p: GaussianParams) -> torch.Tensor:
    return normalize_quat(p.quat)


def get_features(p: GaussianParams) -> torch.Tensor:
    """[C, (d+1)^2, 3] concatenated SH features (ref: gaussian_model.py:113-117)."""
    return torch.cat([p.sh_dc, p.sh_rest], dim=1)


def normalize_quat(q: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return q / norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w,x,y,z) -> [..., 3, 3]; normalizes first.

    ref: utils/general_utils.py:78-99 (build_rotation)
    """
    q = normalize_quat(q)
    r, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - r * z), 2 * (x * z + r * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + r * z), 1 - 2 * (x * x + z * z), 2 * (y * z - r * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - r * y), 2 * (y * z + r * x), 1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def build_scaling_rotation(s: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """L = R @ diag(s), ref: utils/general_utils.py:101-110."""
    R = quat_to_rotmat(q)
    return R * s[..., None, :]


def covariance_3d(scaling: torch.Tensor, scaling_modifier, quat: torch.Tensor) -> torch.Tensor:
    """Packed symmetric covariance [..., 6] = (xx, xy, xz, yy, yz, zz).

    ref: scene/gaussian_model.py:31-36 + utils/general_utils.py:64-76
    """
    L = build_scaling_rotation(scaling_modifier * scaling, quat)
    cov = L @ L.transpose(-1, -2)
    return strip_symmetric(cov)


def strip_symmetric(cov: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 6] upper triangle (ref: utils/general_utils.py:64-76)."""
    return torch.stack([
        cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2],
    ], dim=-1)


def unpack_symmetric(packed: torch.Tensor) -> torch.Tensor:
    """[..., 6] -> [..., 3, 3]."""
    xx, xy, xz, yy, yz, zz = (packed[..., i] for i in range(6))
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
