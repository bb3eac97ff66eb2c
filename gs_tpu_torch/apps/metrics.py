"""Evaluation CLI — port of ``gs_tpu/apps/metrics.py`` (ref: metrics.py:24-103).

Usage: ``python -m gs_tpu_torch.apps.metrics -m <model_dir> [...] [--data_device cuda]``

Walks ``<model>/test/ours_<it>/{renders,gt}``, computes SSIM, PSNR and
LPIPS-vgg on ``--data_device`` (``cuda`` by default) and writes
``results.json`` + ``per_view.json``. LPIPS needs its weights file
(``ops/lpips.py``: ``$GS_TPU_LPIPS_WEIGHTS`` or
``~/.cache/gs_tpu/lpips_vgg.npz``); without it the CLI says so and reports
SSIM/PSNR, as the JAX package does.

SSIM and LPIPS are computed as the JAX CLI computes them, one compiled
executable per view (its ``jit_ssim``, ``gs_tpu/apps/metrics.py:47``, and
the jitted LPIPS distance, ``gs_tpu/ops/lpips.py:110``): on CUDA each is a
``utils/cuda_graphs.py::GraphedFunction``, one graph replay per view and
image size; on the CPU they run eagerly. PSNR stays eager, as the JAX CLI
does not jit it either.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..ops.losses import psnr as psnr_fn
from ..ops.lpips import lpips_vgg
from ..ops.ssim import ssim as ssim_fn
from ..utils.cuda_graphs import GraphedFunction
from .args import resolve_data_device


def read_images(renders_dir: str, gt_dir: str):
    """ref: metrics.py:24-34 (readImages)."""
    from PIL import Image
    renders, gts, names = [], [], []
    for fname in sorted(os.listdir(renders_dir)):
        with Image.open(os.path.join(renders_dir, fname)) as r:
            renders.append(np.asarray(r.convert("RGB"), np.float32) / 255.0)
        with Image.open(os.path.join(gt_dir, fname)) as g:
            gts.append(np.asarray(g.convert("RGB"), np.float32) / 255.0)
        names.append(fname)
    return renders, gts, names


def metric_functions(device="cuda", use_lpips: bool = True) -> tuple:
    """(SSIM, LPIPS) as :func:`evaluate` computes them, each a
    ``GraphedFunction`` (one replay per view on CUDA). LPIPS is None
    without its weights, or unless ``use_lpips``."""
    lpips_fn = None
    if use_lpips:
        try:
            lpips_fn = lpips_vgg(device=device)
        except FileNotFoundError as e:
            print(f"LPIPS unavailable ({e}); reporting SSIM/PSNR only")
    return (GraphedFunction(ssim_fn, label="SSIM"),
            None if lpips_fn is None
            else GraphedFunction(lpips_fn, label="LPIPS"))


@torch.no_grad()
def evaluate(model_paths: list[str], use_lpips: bool = True, device="cuda",
             *, functions: tuple | None = None):
    """ref: metrics.py:36-93 (evaluate). ``functions``: the (SSIM, LPIPS)
    pair to use (LPIPS may be None), :func:`metric_functions`' when
    None."""
    ssim_f, lpips_f = (metric_functions(device, use_lpips)
                       if functions is None else functions)
    full_dict, per_view_dict = {}, {}
    for scene_dir in model_paths:
        print("Scene:", scene_dir)
        full_dict[scene_dir] = {}
        per_view_dict[scene_dir] = {}
        test_dir = os.path.join(scene_dir, "test")
        for method in sorted(os.listdir(test_dir)):
            print("Method:", method)
            method_dir = os.path.join(test_dir, method)
            renders, gts, names = read_images(
                os.path.join(method_dir, "renders"),
                os.path.join(method_dir, "gt"))
            ssims, psnrs, lpipss = [], [], []
            for r, g in zip(renders, gts):
                rc = torch.from_numpy(r.transpose(2, 0, 1).copy()).to(device)
                gc = torch.from_numpy(g.transpose(2, 0, 1).copy()).to(device)
                ssims.append(float(ssim_f(rc, gc)))
                psnrs.append(float(psnr_fn(rc[None], gc[None])[0, 0]))
                if lpips_f is not None:
                    lpipss.append(float(lpips_f(rc, gc)))
            print(f"  SSIM : {np.mean(ssims):>12.7f}")
            print(f"  PSNR : {np.mean(psnrs):>12.7f}")
            if lpipss:
                print(f"  LPIPS: {np.mean(lpipss):>12.7f}")
            entry = {"SSIM": float(np.mean(ssims)),
                     "PSNR": float(np.mean(psnrs))}
            views = {"SSIM": dict(zip(names, map(float, ssims))),
                     "PSNR": dict(zip(names, map(float, psnrs)))}
            if lpipss:
                entry["LPIPS"] = float(np.mean(lpipss))
                views["LPIPS"] = dict(zip(names, map(float, lpipss)))
            full_dict[scene_dir][method] = entry
            per_view_dict[scene_dir][method] = views
        with open(os.path.join(scene_dir, "results.json"), "w") as f:
            json.dump(full_dict[scene_dir], f, indent=True)
        with open(os.path.join(scene_dir, "per_view.json"), "w") as f:
            json.dump(per_view_dict[scene_dir], f, indent=True)
    return full_dict


def main(argv=None):
    parser = argparse.ArgumentParser(description="Metrics script parameters")
    parser.add_argument("--model_paths", "-m", required=True, nargs="+",
                        type=str)
    parser.add_argument("--no_lpips", action="store_true")
    parser.add_argument("--data_device", default="cuda", type=str)
    args = parser.parse_args(argv)
    evaluate(args.model_paths, use_lpips=not args.no_lpips,
             device=resolve_data_device(args.data_device))


if __name__ == "__main__":
    main()
