"""Offline orbit renderer — port of ``gs_tpu/apps/view_orbit.py``, the
serving path's entry point: it loads a trained model directory and renders
a camera orbit around it to PNGs (and an mp4 when ffmpeg is on PATH),
without needing the dataset.

Usage: ``python -m gs_tpu_torch.apps.view_orbit -m <model_dir> [--frames 120]``

The device is ``--data_device`` (``cuda`` by default; a stored ``tpu``, the
JAX package's default, reads as ``cuda``). A frame whose
entries did not fit ``--dup_capacity`` / ``--max_per_tile`` is reported on
stdout.
"""
from __future__ import annotations

import math
import os
import shutil
import subprocess

import numpy as np
import torch

from ..config import ModelConfig, RasterConfig
from ..core.camera import focal2fov, make_camera
from ..data.ply import load_gaussian_ply, search_max_iteration
from ..render import raster_lever_kwargs, render
from .args import (extract_dataclass, get_combined_args, make_parser,
                   resolve_data_device)
from .render import params_from_ply, save_png


def orbit_camera(center: np.ndarray, radius: float, elevation: float,
                 theta: float, width: int, height: int, fovx: float, *,
                 device="cuda"):
    """Camera on a circle around ``center``, looking at it."""
    pos = center + radius * np.array([math.cos(theta),
                                      math.sin(elevation),
                                      math.sin(theta)])
    fwd = center - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0])   # COLMAP convention: Y down
    right = np.cross(fwd, up); right /= np.linalg.norm(right)
    up2 = np.cross(fwd, right)
    Rcw = np.stack([right, up2, fwd], axis=1)   # cam->world columns
    Rwc = Rcw.T
    t = -Rwc @ pos
    fovy = focal2fov(width / (2 * math.tan(fovx / 2)), height)
    # make_camera expects the loader convention: R = Rwc^T
    return make_camera(Rwc.T, t, fovx, fovy, width, height, device=device)


def orbit_geometry(xyz: np.ndarray, radius_scale: float):
    """Orbit center (median position) and radius (90th-percentile spread)."""
    center = np.median(xyz, axis=0)
    spread = np.percentile(np.linalg.norm(xyz - center, axis=1), 90)
    return center, float(spread) * radius_scale


def main(argv=None):
    parser = make_parser("Orbit viewer parameters",
                         include_optimization=False, fill_none=True)
    parser.add_argument("--iteration", default=-1, type=int)
    parser.add_argument("--frames", default=120, type=int)
    parser.add_argument("--width", default=960, type=int)
    parser.add_argument("--height", default=540, type=int)
    parser.add_argument("--radius_scale", default=1.0, type=float)
    parser.add_argument("--elevation", default=0.3, type=float)
    parser.add_argument("--fps", default=30, type=int)
    args = get_combined_args(parser, argv)

    model_cfg = extract_dataclass(ModelConfig, args)
    raster = extract_dataclass(RasterConfig, args)
    device = resolve_data_device(model_cfg.data_device)
    pc_dir = os.path.join(model_cfg.model_path, "point_cloud")
    iteration = (args.iteration if args.iteration != -1
                 else search_max_iteration(pc_dir))
    d = load_gaussian_ply(os.path.join(pc_dir, f"iteration_{iteration}",
                                       "point_cloud.ply"))
    params, alive = params_from_ply(d, device=device)
    bg = torch.full((3,), 1.0 if model_cfg.white_background else 0.0,
                    device=device)
    center, radius = orbit_geometry(d["xyz"], args.radius_scale)

    out_dir = os.path.join(model_cfg.model_path, f"orbit_{iteration}")
    os.makedirs(out_dir, exist_ok=True)
    fovx = math.radians(70.0)
    with torch.no_grad():
        for i in range(args.frames):
            theta = 2 * math.pi * i / args.frames
            cam = orbit_camera(center, radius, args.elevation, theta,
                               args.width, args.height, fovx, device=device)
            out = render(cam, params, bg, active_sh_degree=d["sh_degree"],
                         alive=alive, backend=raster.backend,
                         dup_capacity=raster.dup_capacity,
                         max_per_tile=raster.max_per_tile, chunk=raster.chunk,
                         **raster_lever_kwargs(raster))
            save_png(os.path.join(out_dir, f"{i:05d}.png"),
                     out.image.cpu().numpy())
            if out.overflow.item():
                print(f"\nframe {i}: overflow (num_duplicates "
                      f"{out.num_duplicates.item()}, max_tile_len "
                      f"{out.max_tile_len.item()}) — entries were dropped; "
                      "raise --dup_capacity / --max_per_tile")
            print(f"\rorbit {i + 1}/{args.frames}", end="", flush=True)
    print()

    if shutil.which("ffmpeg"):
        mp4 = os.path.join(model_cfg.model_path, f"orbit_{iteration}.mp4")
        subprocess.run(
            ["ffmpeg", "-y", "-framerate", str(args.fps), "-i",
             os.path.join(out_dir, "%05d.png"), "-pix_fmt", "yuv420p", mp4],
            check=False, capture_output=True)
        print(f"wrote {mp4}")
    else:
        print(f"frames in {out_dir} (ffmpeg not found; skipped mp4)")


if __name__ == "__main__":
    main()
