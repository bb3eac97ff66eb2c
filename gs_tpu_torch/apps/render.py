"""Rendering CLI — port of ``gs_tpu/apps/render.py`` (ref: render.py:30-76),
with the model loading and image output the other CLIs share.

Usage: ``python -m gs_tpu_torch.apps.render -m <model_dir> [--iteration N] [--skip_train] [--skip_test]``

Loads the trained model at iteration N (default: latest) and renders the
train/test splits of its dataset to
``<model>/{train,test}/ours_<N>/{renders,gt}/*.png`` without gradients
(K2 + K1), keeping the right half of each image when ``train_test_exp``.
A view that overflows ``--dup_capacity`` / ``--max_per_tile`` is rendered
again at grown buffers, and said so; one that overflows even at the
binning's limit is reported.
The device is ``--data_device`` (``cuda`` by default; a stored ``tpu``
reads as ``cuda``).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..config import ModelConfig, PipelineConfig, RasterConfig
from ..core.gaussians import GaussianParams
from ..data.scene import Scene
from ..render import render_grown
from .args import (extract_dataclass, get_combined_args, make_parser,
                   resolve_data_device)


def save_png(path: str, chw: np.ndarray):
    from PIL import Image
    arr = (np.clip(chw, 0.0, 1.0) * 255 + 0.5).astype(np.uint8)
    Image.fromarray(arr.transpose(1, 2, 0)).save(path)


def params_from_ply(d: dict, capacity: int | None = None, *, device="cuda"):
    """Padded GaussianParams and alive mask on ``device`` from
    ``data.ply.load_gaussian_ply`` output. Capacity rounds up to a multiple
    of 1024, as in the JAX package, so both pad alike."""
    n = d["xyz"].shape[0]
    cap = capacity or max(1024, -(-n // 1024) * 1024)

    def pad(x, fill=0.0):
        cfg = [(0, cap - n)] + [(0, 0)] * (x.ndim - 1)
        return torch.tensor(np.pad(np.asarray(x, np.float32), cfg,
                                   constant_values=fill), device=device)

    quat = pad(d["quat"])
    quat[n:, 0] = 1.0
    params = GaussianParams(
        xyz=pad(d["xyz"]), sh_dc=pad(d["sh_dc"]), sh_rest=pad(d["sh_rest"]),
        log_scale=pad(d["log_scale"], -10.0),
        quat=quat,
        logit_opacity=pad(d["logit_opacity"], -10.0))
    alive = torch.arange(cap, device=device) < n
    return params, alive


def load_exposures(model_path: str):
    """image_name -> 3x4 exposure matrix from exposure.json (upstream saves
    per-image trained exposures; applied when train_test_exp)."""
    path = os.path.join(model_path, "exposure.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return {k: np.asarray(v, np.float32) for k, v in json.load(f).items()}


@torch.no_grad()
def render_set(model_path: str, name: str, iteration: int, cams, params,
               alive, sh_degree: int, bg, pipe: PipelineConfig,
               raster: RasterConfig, train_test_exp: bool):
    """ref: render.py:30-46 (render_set). A view that overflows ``raster``'s
    buffers renders again at grown ones (``render_grown``), which the
    following views keep. Returns the RasterConfig of the last view."""
    render_dir = os.path.join(model_path, name, f"ours_{iteration}", "renders")
    gt_dir = os.path.join(model_path, name, f"ours_{iteration}", "gt")
    os.makedirs(render_dir, exist_ok=True)
    os.makedirs(gt_dir, exist_ok=True)
    exposures = load_exposures(model_path) if train_test_exp else None

    for idx, cam in enumerate(cams):
        out, raster = render_grown(
            cam.camera, params, bg, raster, label=f"{name} view {idx}",
            active_sh_degree=sh_degree, antialiasing=pipe.antialiasing,
            convert_SHs_python=pipe.convert_SHs_python,
            compute_cov3D_python=pipe.compute_cov3D_python, alive=alive)
        rendering = out.image.cpu().numpy()
        if exposures is not None and cam.info.image_name in exposures:
            e = exposures[cam.info.image_name]
            rendering = (np.einsum("chw,ck->khw", rendering, e[:3, :3])
                         + e[:3, 3, None, None])
        gt = cam.image
        if train_test_exp:   # ref: render.py:41-43
            rendering = rendering[..., rendering.shape[-1] // 2:]
            gt = gt[..., gt.shape[-1] // 2:]
        save_png(os.path.join(render_dir, f"{idx:05d}.png"), rendering)
        save_png(os.path.join(gt_dir, f"{idx:05d}.png"), gt)
        print(f"\r{name} {idx + 1}/{len(cams)}", end="", flush=True)
    print()
    return raster


def main(argv=None):
    parser = make_parser("Testing script parameters",
                         include_optimization=False, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--skip_train", action="store_true")
    parser.add_argument("--skip_test", action="store_true")
    parser.add_argument("--quiet", action="store_true")
    args = get_combined_args(parser, argv)

    model_cfg = extract_dataclass(ModelConfig, args)
    pipe = extract_dataclass(PipelineConfig, args)
    raster = extract_dataclass(RasterConfig, args)
    device = resolve_data_device(model_cfg.data_device)
    print(f"Rendering {model_cfg.model_path}")

    scene = Scene(model_cfg.source_path, "",
                  images=model_cfg.images, depths=model_cfg.depths or "",
                  resolution=model_cfg.resolution,
                  white_background=model_cfg.white_background,
                  eval_split=model_cfg.eval,
                  train_test_exp=model_cfg.train_test_exp,
                  shuffle=False, device=device)
    scene.model_path = model_cfg.model_path
    d, iteration = scene.load_ply(args.iteration)
    params, alive = params_from_ply(d, device=device)
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=device)

    if not args.skip_train:
        raster = render_set(model_cfg.model_path, "train", iteration,
                            scene.get_train_cameras(), params, alive,
                            d["sh_degree"], bg, pipe, raster,
                            model_cfg.train_test_exp)
    if not args.skip_test and scene.get_test_cameras():
        render_set(model_cfg.model_path, "test", iteration,
                   scene.get_test_cameras(), params, alive, d["sh_degree"],
                   bg, pipe, raster, model_cfg.train_test_exp)


if __name__ == "__main__":
    main()
