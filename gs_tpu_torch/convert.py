"""Carry weights, cameras and training state across from the JAX package.

The two packages share nothing at import time, so values cross as numpy
arrays: a ``gs_tpu`` ``GaussianParams`` as ``{field: np.asarray(leaf)}``, a
``gs_tpu`` ``Camera`` as its five array fields plus width and height, a
``gs_tpu`` ``TrainState`` as ``{field: array}`` with its three
``GaussianParams`` fields (``params``, ``m``, ``v``) as nested dicts. The
field names and ``[C, ...]`` layouts are the same on both sides, so both
packages can step from one state. A ``gs_tpu`` ``PackedState`` crosses as
``{field: array}`` too, its [R, C] blocks (``packed``, ``m``, ``v``) as they
are.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.camera import Camera
from .core.gaussians import GaussianParams
from .models.gaussian_model import TrainState
from .models.packed_state import PackedState

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


PARAM_FIELDS = ("params", "m", "v")


def state_to_numpy(state: TrainState) -> dict:
    """TrainState -> {field: numpy array}, the params/m/v fields as
    {parameter field: numpy array}."""
    return {k: params_to_numpy(v) if k in PARAM_FIELDS
            else v.detach().cpu().numpy()
            for k, v in state._asdict().items()}


def state_from_numpy(arrays: dict, device="cuda") -> TrainState:
    """The inverse of :func:`state_to_numpy`; each array keeps its dtype
    (float32, int32 counters, the bool ``alive`` mask)."""
    return TrainState(**{
        k: params_from_numpy(arrays[k], device) if k in PARAM_FIELDS
        else torch.tensor(np.asarray(arrays[k]), device=device)
        for k in TrainState._fields})


def packed_state_to_numpy(state: PackedState) -> dict:
    """PackedState -> {field: numpy array}."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


def packed_state_from_numpy(arrays: dict, device="cuda") -> PackedState:
    """A ``gs_tpu`` PackedState's arrays -> the port's PackedState; each
    array keeps its dtype."""
    return PackedState(**{
        k: torch.tensor(np.asarray(arrays[k]), device=device)
        for k in PackedState._fields})
