"""Initial Gaussians from a point cloud — the part of
``gs_tpu/models/gaussian_model.py`` the serving path needs.

Tensors are padded to a capacity with an ``alive`` mask, as in the JAX
package (dead slots: tiny scale, near-zero opacity, identity rotation).
The training state, Adam and density control come with the training slice.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..core.gaussians import GaussianParams, inverse_sigmoid
from ..core.sh import rgb2sh
from ..core.spatial import mean_sq_dist_to_3nn


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
