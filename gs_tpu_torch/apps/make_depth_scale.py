"""Fit per-image depth-prior scales — port of
``gs_tpu/apps/make_depth_scale.py``, the ``utils/make_depth_scale.py`` tool
the reference README documents for depth-regularized training (ref:
README.md:531-552).

For every image: project the COLMAP sparse points into the view, sample the
monocular inverse-depth map at the projected pixels, and least-squares fit
``mono_inv ≈ scale * (1/z) + offset`` with inlier trimming. Writes
``sparse/0/depth_params.json`` ({image: {scale, offset}}), which
``data/camera_utils.py`` reads. Numpy only, in float64.

Usage: ``python -m gs_tpu_torch.apps.make_depth_scale -s <dataset> -d depths``
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from ..data import colmap
from ..data.camera_utils import load_invdepth


def fit_scale_offset(mono: np.ndarray, inv_z: np.ndarray,
                     trim: float = 0.2, iters: int = 3):
    """Robust linear fit mono = scale * inv_z + offset (trimmed lstsq)."""
    keep = np.ones(len(mono), bool)
    scale, offset = 0.0, 0.0
    for _ in range(iters):
        if keep.sum() < 8:
            return 0.0, 0.0, 0
        A = np.stack([inv_z[keep], np.ones(keep.sum())], axis=1)
        sol, *_ = np.linalg.lstsq(A, mono[keep], rcond=None)
        scale, offset = float(sol[0]), float(sol[1])
        resid = np.abs(mono - (scale * inv_z + offset))
        thresh = np.quantile(resid[keep], 1.0 - trim)
        keep = resid <= thresh
    return scale, offset, int(keep.sum())


def main(argv=None):
    parser = argparse.ArgumentParser(description="Depth-scale fitting")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--depths", "-d", default="depths")
    parser.add_argument("--min_points", type=int, default=20)
    args = parser.parse_args(argv)

    sparse = os.path.join(args.source_path, "sparse", "0")
    try:
        images = colmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        cameras = colmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
        xyz, _, _ = colmap.read_points3D_binary(os.path.join(sparse, "points3D.bin"))
    except (FileNotFoundError, IOError):
        images = colmap.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        cameras = colmap.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))
        xyz, _, _ = colmap.read_points3D_text(os.path.join(sparse, "points3D.txt"))

    depth_dir = os.path.join(args.source_path, args.depths)
    params = {}
    for im in images.values():
        base = os.path.splitext(os.path.basename(im.name))[0]
        dpath = os.path.join(depth_dir, base + ".png")
        if not os.path.exists(dpath):
            continue
        intr = cameras[im.camera_id]
        if intr.model == "PINHOLE":
            fx, fy, cx, cy = intr.params[:4]
        elif intr.model == "SIMPLE_PINHOLE":
            fx = fy = intr.params[0]
            cx, cy = intr.params[1:3]
        else:
            continue
        mono_map = load_invdepth(dpath, (intr.width, intr.height))

        Rwc = colmap.qvec2rotmat(im.qvec)
        pts_cam = xyz @ Rwc.T + im.tvec
        z = pts_cam[:, 2]
        front = z > 0.1
        u = fx * pts_cam[front, 0] / z[front] + cx
        v = fy * pts_cam[front, 1] / z[front] + cy
        inb = (u >= 0) & (u < intr.width - 1) & (v >= 0) & (v < intr.height - 1)
        ui = u[inb].astype(np.int32)
        vi = v[inb].astype(np.int32)
        mono = mono_map[vi, ui].astype(np.float64)
        inv_z = (1.0 / z[front][inb]).astype(np.float64)
        valid = mono > 0
        if valid.sum() < args.min_points:
            params[base] = {"scale": 0.0, "offset": 0.0}
            continue
        scale, offset, n = fit_scale_offset(mono[valid], inv_z[valid])
        # depth_params convention (read by camera_utils.load_camera):
        # aligned_inv = mono * scale + offset  => invert the fit
        if abs(scale) < 1e-12:
            params[base] = {"scale": 0.0, "offset": 0.0}
        else:
            params[base] = {"scale": 1.0 / scale, "offset": -offset / scale}

    out_path = os.path.join(sparse, "depth_params.json")
    with open(out_path, "w") as f:
        json.dump(params, f, indent=2)
    scales = np.array([p["scale"] for p in params.values() if p["scale"] > 0])
    med = float(np.median(scales)) if len(scales) else 0.0
    print(f"wrote {out_path}: {len(params)} images, med_scale={med:.4f}")


if __name__ == "__main__":
    main()
