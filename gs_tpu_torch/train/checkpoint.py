"""Training checkpoints — port of ``gs_tpu/train/checkpoint.py``: the full
TrainState (params, Adam moments, densification statistics, exposure) plus
the iteration, written as ``torch.save`` of a dict, as the reference writes
``chkpnt{i}.pth`` (ref: train.py:181-183, scene/gaussian_model.py:67-99
capture/restore). The capacity, SH degree, image count and spatial learning
rate scale are stored beside the tensors.

``load_checkpoint`` also reads the JAX package's format: the ``GSTPUCK1``
magic, a 20-byte ``<iiiif`` header (iteration, capacity, SH rest dimension,
image count, spatial learning rate scale) and a flax msgpack blob of the
state dict, decoded by the port's own reader (``utils/msgpack_reader.py``;
neither ``flax`` nor ``msgpack`` is needed). Its leaves arrive bitwise.
"""
from __future__ import annotations

import os
import struct

import torch

from ..convert import PARAM_FIELDS, state_from_numpy
from ..core.gaussians import GaussianParams
from ..models.gaussian_model import TrainState
from ..models.packed_state import PackedState, unpack_state
from ..utils.msgpack_reader import restore_flax

GS_TPU_MAGIC = b"GSTPUCK1"


def save_checkpoint(path: str, state, iteration: int,
                    spatial_lr_scale: float = 1.0):
    """``state``: a TrainState, or a PackedState, unpacked here so the file
    is the same whatever layout trained it (``load_checkpoint`` returns a
    TrainState either way)."""
    if isinstance(state, PackedState):
        state = unpack_state(state)
    tensors = {k: ({f: t.detach().cpu() for f, t in v._asdict().items()}
                   if isinstance(v, GaussianParams) else v.detach().cpu())
               for k, v in state._asdict().items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state": tensors, "iteration": int(iteration),
                "capacity": state.capacity,
                "sh_degree": state.params.sh_degree,
                "num_images": state.exposure.shape[0],
                "spatial_lr_scale": float(spatial_lr_scale)}, path)


def _load_gs_tpu(data: bytes, path: str,
                 device) -> tuple[TrainState, int, float]:
    """The JAX package's checkpoint after its magic: header, then blob."""
    iteration, capacity, rest_dim, num_images, slrs = struct.unpack_from(
        "<iiiif", data)
    tree = restore_flax(memoryview(data)[20:])
    missing = [k for k in TrainState._fields if k not in tree] + [
        f"{k}.{f}" for k in PARAM_FIELDS if isinstance(tree.get(k), dict)
        for f in GaussianParams._fields if f not in tree[k]]
    if missing:
        raise ValueError(f"{path}: the JAX checkpoint lacks {missing}")
    state = state_from_numpy(tree, device)
    if (state.capacity, state.params.sh_rest.shape[1],
            state.exposure.shape[0]) != (capacity, rest_dim, num_images):
        raise ValueError(f"{path}: tensors disagree with the header's "
                         "capacity, SH rest dimension or image count")
    return state, iteration, slrs


def load_checkpoint(path: str, device="cuda") -> tuple[TrainState, int, float]:
    """Returns (state on ``device``, iteration, spatial_lr_scale), from a
    checkpoint of either package."""
    with open(path, "rb") as f:
        if f.read(len(GS_TPU_MAGIC)) == GS_TPU_MAGIC:
            return _load_gs_tpu(f.read(), path, device)
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
