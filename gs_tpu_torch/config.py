"""Configuration dataclasses — the same knob names and defaults as
``gs_tpu/config.py`` (itself the reference flag system, ref:
arguments/__init__.py:47-93), so a model directory written by either package
configures the other. The one default that differs: ``data_device`` is
``"cuda"``.

Persisted as JSON; ``save_config`` also emits a reference-compatible
``cfg_args`` Namespace-repr file.
"""
from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass


@dataclass
class ModelConfig:
    # ref: arguments/__init__.py:47-63 (ModelParams)
    sh_degree: int = 3
    source_path: str = ""
    model_path: str = ""
    images: str = "images"
    depths: str = ""
    resolution: int = -1
    white_background: bool = False
    train_test_exp: bool = False
    data_device: str = "cuda"
    eval: bool = False
    live: bool = False           # the fork's SLAM addition (ref: arguments/__init__.py:57)


@dataclass
class PipelineConfig:
    # ref: arguments/__init__.py:65-71 (PipelineParams)
    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False
    antialiasing: bool = False


@dataclass
class OptimizationConfig:
    # ref: arguments/__init__.py:73-93 (OptimizationParams) + upstream
    # exposure/depth knobs (README.md:148-218)
    iterations: int = 30000
    position_lr_init: float = 0.00016
    position_lr_final: float = 0.0000016
    position_lr_delay_mult: float = 0.01
    position_lr_max_steps: int = 30000
    feature_lr: float = 0.0025
    opacity_lr: float = 0.05
    scaling_lr: float = 0.005
    rotation_lr: float = 0.001
    exposure_lr_init: float = 0.01
    exposure_lr_final: float = 0.001
    exposure_lr_delay_steps: int = 0
    exposure_lr_delay_mult: float = 0.0
    percent_dense: float = 0.01
    lambda_dssim: float = 0.2
    densification_interval: int = 100
    opacity_reset_interval: int = 3000
    densify_from_iter: int = 500
    densify_until_iter: int = 15000
    densify_grad_threshold: float = 0.0002
    depth_l1_weight_init: float = 1.0
    depth_l1_weight_final: float = 0.01
    random_background: bool = False
    optimizer_type: str = "default"   # or "sparse_adam"


@dataclass
class RasterConfig:
    """Rasterizer knobs (no reference counterpart): the fields of
    ``gs_tpu.config.RasterConfig`` that the port reads. Those that select
    TPU kernels (``tile_block``, ``pallas_expand``, ``pallas_fold``) are
    left out: the CUDA backend always runs its kernels. ``bf16_features``
    streams the colours and invdepth through the tile sort as bf16 pairs
    on the ``cuda`` backend, on one device (``ops/rasterize.py``)."""
    backend: str = "auto"            # auto (= cuda) | depthwise | binned | cuda
    dup_capacity: int = 1 << 20
    max_per_tile: int = 4096
    chunk: int = 128
    bf16_features: bool = False
    exact_cull: bool = True          # drop expanded entries whose tile the
    # ellipse provably never reaches (alpha < 1/255 over the whole rect)
    # before the tile sort — shrinks per-tile ranges at zero output change
    band_assign: str = "cost"        # multi-GPU tile-row assignment: "cost"
    # re-deals rows to devices each frame by duplicate cost (snake order);
    # "stride" is the fixed interleave (device d owns rows d, d+k, ...)
    visible_capacity: int = 0        # multi-GPU (--mesh) only: per-device
    # cap on packets entering the all-gather (each device compacts its
    # shard visible-first). 0 = auto (the trainer sizes it from the
    # per-shard alive counts and grows it on overflow), -1 = gather the
    # whole padded shard, >0 = an explicit cap


def asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


def from_dict(cls, d: dict):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in names})


def save_config(model_path: str, model: ModelConfig, pipe: PipelineConfig,
                opt: OptimizationConfig):
    os.makedirs(model_path, exist_ok=True)
    with open(os.path.join(model_path, "config.json"), "w") as f:
        json.dump({"model": asdict(model), "pipeline": asdict(pipe),
                   "optimization": asdict(opt)}, f, indent=2)
    # reference-compatible cfg_args (ref: train.py:196-197)
    ns_fields = dict(asdict(model))
    ns_fields.pop("depths", None)
    body = ", ".join(f"{k}={v!r}" for k, v in sorted(ns_fields.items()))
    with open(os.path.join(model_path, "cfg_args"), "w") as f:
        f.write(f"Namespace({body})")


def load_config(model_path: str):
    with open(os.path.join(model_path, "config.json")) as f:
        d = json.load(f)
    return (from_dict(ModelConfig, d["model"]),
            from_dict(PipelineConfig, d["pipeline"]),
            from_dict(OptimizationConfig, d["optimization"]))
