"""Carry weights and cameras across from the JAX package.

The two packages share nothing at import time, so values cross as numpy
arrays: a ``gs_tpu`` ``GaussianParams`` as ``{field: np.asarray(leaf)}``, a
``gs_tpu`` ``Camera`` as its five array fields plus width and height. The
field names and ``[C, ...]`` layouts are the same on both sides.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.gaussians import GaussianParams

CAMERA_FIELDS = ("world_view", "full_proj", "camera_center", "tan_fovx",
                 "tan_fovy")


def params_from_numpy(arrays: dict, device="cuda") -> GaussianParams:
    """{xyz, sh_dc, sh_rest, log_scale, quat, logit_opacity} numpy arrays ->
    float32 GaussianParams on ``device``."""
    return GaussianParams(**{
        k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in GaussianParams._fields})


def params_to_numpy(params: GaussianParams) -> dict:
    return {k: getattr(params, k).detach().cpu().numpy()
            for k in GaussianParams._fields}


def camera_from_numpy(arrays: dict, width: int, height: int,
                      device="cuda") -> Camera:
    """The five array fields of a camera (``CAMERA_FIELDS``) -> Camera."""
    return Camera(**{
        k: torch.tensor(np.asarray(arrays[k], np.float32), device=device)
        for k in CAMERA_FIELDS}, width=int(width), height=int(height))
