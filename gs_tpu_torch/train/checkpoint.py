"""Training checkpoints — port of ``gs_tpu/train/checkpoint.py``: the full
TrainState (params, Adam moments, densification statistics, exposure) plus
the iteration, written as ``torch.save`` of a dict, as the reference writes
``chkpnt{i}.pth`` (ref: train.py:181-183, scene/gaussian_model.py:67-99
capture/restore). The capacity, SH degree, image count and spatial learning
rate scale are stored beside the tensors.

The JAX package writes a flax msgpack blob instead; reading one is not
ported (``ROADMAP.md``).
"""
from __future__ import annotations

import os

import torch

from ..core.gaussians import GaussianParams
from ..models.gaussian_model import TrainState


def save_checkpoint(path: str, state: TrainState, iteration: int,
                    spatial_lr_scale: float = 1.0):
    tensors = {k: ({f: t.detach().cpu() for f, t in v._asdict().items()}
                   if isinstance(v, GaussianParams) else v.detach().cpu())
               for k, v in state._asdict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state": tensors, "iteration": int(iteration),
                "capacity": state.capacity,
                "sh_degree": state.params.sh_degree,
                "num_images": state.exposure.shape[0],
                "spatial_lr_scale": float(spatial_lr_scale)}, path)


def load_checkpoint(path: str, device="cuda") -> tuple[TrainState, int, float]:
    """Returns (state on ``device``, iteration, spatial_lr_scale)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    tensors = blob["state"]
    state = TrainState(**{
        k: (GaussianParams(**{f: t.to(device) for f, t in v.items()})
            if isinstance(v, dict) else v.to(device))
        for k, v in tensors.items()})
    if (state.capacity, state.params.sh_degree, state.exposure.shape[0]) != (
            blob["capacity"], blob["sh_degree"], blob["num_images"]):
        raise ValueError(f"{path}: tensors disagree with the stored capacity, "
                         "SH degree or image count")
    return state, blob["iteration"], blob["spatial_lr_scale"]
