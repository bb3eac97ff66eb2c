"""The full training schedule on the port: the counterpart of the JAX
package's ``scripts/schedule_run.py``, with its own copy of that script's
scene construction (``scripts/schedule_run.py:65-183``).

A synthetic multi-view scene (1,200 coloured Gaussians and a ground slab,
seed 3), its views rendered by the port's own K1 as the ground truth, one
in eight held out; 300 random initial points; the reference schedule (SH
ramp to degree 3, opacity resets every ``--reset_interval``, densification
until 4/7 of the run) through ``Trainer.train(block_scan=True)``, so the
steps run as CUDA graphs (``train/graph.py``). Reports the held-out PSNR
trajectory, the recovery after each opacity reset, the final Gaussian
count, ``overflow_exhausted``, ``capacity_exhausted``, the captures and
the wall time, and writes them as JSON.

The defaults are the configuration of the JAX run in
``SCHEDULE_RUN_r5.json`` (30,000 iterations, 108 views at 320x240).

Run on the card:  python3 tools/schedule_run.py [--out SCHEDULE_RUN_torch.json]
Rehearse on the CPU:  python3 tools/schedule_run.py --device cpu --iters 600
    --views 16 --res 64 48
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def ring_camera(angle, radius, height, width_px, height_px, device,
                fov_deg=55.0):
    from gs_tpu_torch.core.camera import focal2fov, make_camera
    pos = np.array([radius * math.sin(angle), height,
                    radius * math.cos(angle)])
    z = -pos / np.linalg.norm(pos)                     # look at the origin
    x = np.cross(np.array([0.0, 1.0, 0.0]), z)
    x /= np.linalg.norm(x)
    y = np.cross(z, x)
    R_w2c = np.stack([x, y, z])                        # rows
    t = -R_w2c @ pos
    fovx = math.radians(fov_deg)
    fovy = focal2fov(width_px / (2 * math.tan(fovx / 2)), height_px)
    return make_camera(R_w2c.T, t, fovx, fovy, width_px, height_px,
                       device=device)


def make_gt_scene(rng, device, n=1200):
    """A coloured Gaussian soup and a ground slab, drawn in the JAX
    script's order from the same generator."""
    import torch
    from gs_tpu_torch.core.gaussians import GaussianParams, inverse_sigmoid
    from gs_tpu_torch.core.sh import rgb2sh
    m = n // 4
    xyz = np.concatenate([
        rng.uniform(-1.6, 1.6, (n - m, 3)) * np.array([1, 0.8, 1]),
        np.concatenate([rng.uniform(-2.2, 2.2, (m, 1)),
                        np.full((m, 1), -1.0) + rng.normal(0, 0.02, (m, 1)),
                        rng.uniform(-2.2, 2.2, (m, 1))], axis=1),
    ]).astype(np.float32)
    colors = rng.uniform(0.05, 0.95, (n, 3)).astype(np.float32)

    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return GaussianParams(
        xyz=t(xyz),
        sh_dc=rgb2sh(t(colors))[:, None, :],
        sh_rest=torch.zeros((n, 15, 3), device=device),
        log_scale=t(rng.uniform(-3.2, -2.2, (n, 3))),
        quat=t(rng.normal(0, 1, (n, 4)) + np.array([2.0, 0, 0, 0])),
        logit_opacity=inverse_sigmoid(t(rng.uniform(0.5, 0.95, (n, 1)))))


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else ""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=30_000)
    ap.add_argument("--views", type=int, default=108)
    ap.add_argument("--res", type=int, nargs=2, default=(320, 240))
    ap.add_argument("--reset_interval", type=int, default=2000,
                    help="opacity reset interval; 0 disables resets")
    ap.add_argument("--initial_capacity", type=int, default=1 << 15)
    ap.add_argument("--dup_capacity", type=int, default=1 << 20)
    ap.add_argument("--max_per_tile", type=int, default=4096)
    ap.add_argument("--densify_grad_threshold", type=float, default=0.0,
                    help="0: 1e-4 scaled by sqrt(pixels / (160 x 120)), as "
                         "the JAX script's")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="SCHEDULE_RUN_torch.json")
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    import torch
    from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                     PipelineConfig, RasterConfig)
    from gs_tpu_torch.data.camera_utils import LoadedCamera
    from gs_tpu_torch.data.dataset_readers import CameraInfo
    from gs_tpu_torch.render import render
    from gs_tpu_torch.train.loop import Trainer

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("schedule_run: no CUDA device (pass --device cpu "
                         "to rehearse on the CPU)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line() if dev.type == "cuda" else "cpu"
    print(card, flush=True)

    rng = np.random.default_rng(3)
    W, H = args.res
    gt_params = make_gt_scene(rng, dev)
    cams = [ring_camera(2 * math.pi * i / args.views,
                        radius=5.0 + 0.5 * math.sin(3 * i),
                        height=0.8 + 0.6 * math.cos(2 * i), width_px=W,
                        height_px=H, device=dev)
            for i in range(args.views)]

    t0 = time.perf_counter()
    loaded = []
    with torch.no_grad():
        for i, c in enumerate(cams):
            out = render(c, gt_params, torch.zeros(3, device=dev),
                         active_sh_degree=0, dup_capacity=1 << 18,
                         max_per_tile=2048)
            if bool(out.overflow):
                raise RuntimeError(f"ground-truth view {i} overflowed")
            img = torch.clamp(out.image, 0, 1).cpu().numpy()
            info = CameraInfo(uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0,
                              fovy=0.8, image_path="", image_name=f"v{i:03d}",
                              width=W, height=H)
            loaded.append(LoadedCamera(
                camera=c, info=info, image=img,
                alpha_mask=np.ones((1, H, W), np.float32), invdepth=None,
                depth_mask=None, depth_reliable=False))
    gt_mean = float(np.mean([c.image.mean() for c in loaded]))
    print(f"ground truth: {args.views} views {W}x{H} by K1 in "
          f"{time.perf_counter() - t0:.2f} s, mean intensity {gt_mean:.3f}",
          flush=True)
    if not gt_mean > 0.01:
        raise RuntimeError("the ground-truth views are black")
    train_cams = [c for i, c in enumerate(loaded) if i % 8 != 0]
    test_cams = [c for i, c in enumerate(loaded) if i % 8 == 0]

    # a sparse random cloud: densification must do the work
    n0 = 300
    pts = rng.uniform(-2.0, 2.0, (n0, 3))
    cols = rng.uniform(0, 1, (n0, 3))

    reset_interval = args.reset_interval or (10 * args.iters)
    gthr = args.densify_grad_threshold or (
        1e-4 * math.sqrt(W * H / (160.0 * 120.0)))
    opt = OptimizationConfig(
        iterations=args.iters, position_lr_max_steps=args.iters,
        densify_from_iter=500, densify_until_iter=args.iters * 4 // 7,
        densification_interval=100, opacity_reset_interval=reset_interval,
        densify_grad_threshold=gthr)
    raster = RasterConfig(dup_capacity=args.dup_capacity,
                          max_per_tile=args.max_per_tile, chunk=64)
    tr = Trainer(train_cams, (pts, cols, np.zeros_like(pts)),
                 spatial_lr_scale=4.0,
                 model_cfg=ModelConfig(sh_degree=3, data_device=str(dev)),
                 opt=opt, pipe=PipelineConfig(), raster=raster,
                 test_cams=test_cams,
                 initial_capacity=args.initial_capacity)

    trajectory = []
    t0 = time.perf_counter()

    def on_test(i, report, trainer):
        psnr = report["test"].get("psnr", float("nan"))
        tpsnr = report.get("train_sample", {}).get("psnr", float("nan"))
        n_alive = trainer.num_alive()
        sh_deg = min(i // 1000, 3)
        trajectory.append({"iter": i, "test_psnr": round(psnr, 3),
                           "train_psnr": round(tpsnr, 3),
                           "n_gaussians": n_alive, "sh_degree": sh_deg,
                           "wall_s": round(time.perf_counter() - t0, 1)})
        print(f"[{i:5d}] psnr={psnr:.2f} train={tpsnr:.2f} n={n_alive} "
              f"sh={sh_deg} ema_loss={trainer.ema_loss:.4f}", flush=True)

    test_iters = sorted(set(
        list(range(500, args.iters + 1, 500))
        + [r + d for r in range(reset_interval, args.iters, reset_interval)
           for d in (-50, 100, 400)]))
    tr.train(test_iterations=test_iters, on_test=on_test, block_scan=True)
    wall = time.perf_counter() - t0

    by_iter = {t["iter"]: t for t in trajectory}
    # the reference resets opacity only inside the densify window
    # (train.py:157-167)
    resets = list(range(reset_interval, opt.densify_until_iter,
                        reset_interval))
    recovery = []
    for r in resets:
        pre = by_iter.get(r - 50, {}).get("test_psnr")
        post = by_iter.get(r + 400, {}).get("test_psnr")
        if pre and post:
            recovery.append({"reset_at": r, "psnr_pre": pre,
                             "psnr_post400": post,
                             "recovered": bool(post >= pre - 0.5)})
    final_n = tr.num_alive()
    result = {
        "config": {"iters": args.iters, "views": args.views, "res": [W, H],
                   "init_points": n0,
                   "opacity_reset_interval": args.reset_interval,
                   "densify_until": opt.densify_until_iter},
        "final": {"test_psnr": trajectory[-1]["test_psnr"] if trajectory
                  else None,
                  "n_gaussians": final_n,
                  "growth_factor": round(final_n / n0, 1),
                  "capacity": tr.capacity,
                  "dup_capacity": tr.raster.dup_capacity,
                  "overflow_exhausted": tr.overflow_exhausted,
                  "capacity_exhausted": tr.capacity_exhausted,
                  "wall_s": round(wall, 1)},
        "captures": [{k: (round(v, 1) if isinstance(v, float) else v)
                      for k, v in c.items()} for c in tr.captures],
        "opacity_reset_recovery": recovery,
        "trajectory": trajectory,
        "device": card,
    }
    with open(args.out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result["final"]))
    print(f"recovery: {recovery}")
    if final_n < 10 * n0:
        raise SystemExit(f"densification grew only {final_n}/{n0}")


if __name__ == "__main__":
    main()
