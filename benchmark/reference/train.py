"""Plain PyTorch reference of 3D Gaussian Splatting's training step (Kerbl
et al., SIGGRAPH 2023; their ``train.py``): render, loss (1 - lambda) L1 +
lambda (1 - SSIM), backward, and Adam per parameter group (eps 1e-15, one
step count for all groups, the position rate on the log-linear schedule).
It imports nothing of the program under test.

Parameters are a dict of leaves over the alive Gaussians: xyz [N, 3], sh
[N, 16, 3], log_scale [N, 3], quat [N, 4], logit [N]. Their Adam groups
split ``sh`` into its DC and rest, as 3DGS's f_dc and f_rest.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import render as R

B1, B2, EPS = 0.9, 0.999, 1e-15


def expon_lr(step: int, lr_init: float, lr_final: float,
             max_steps: int) -> float:
    """3DGS's ``get_expon_lr_func`` without delay: log-linear from
    ``lr_init`` to ``lr_final`` over ``max_steps``."""
    t = min(max(step / max_steps, 0.0), 1.0)
    return math.exp(math.log(lr_init) * (1 - t) + math.log(lr_final) * t)


def group_lrs(opt: dict, iteration: int, spatial_lr_scale: float) -> dict:
    return {
        "xyz": expon_lr(iteration, opt["position_lr_init"] * spatial_lr_scale,
                        opt["position_lr_final"] * spatial_lr_scale,
                        opt["position_lr_max_steps"]),
        "sh_dc": opt["feature_lr"],
        "sh_rest": opt["feature_lr"] / 20.0,
        "log_scale": opt["scaling_lr"],
        "quat": opt["rotation_lr"],
        "logit": opt["opacity_lr"],
    }


def split(params: dict) -> dict:
    """The leaves by Adam group: ``sh`` split into DC and rest."""
    out = {k: params[k] for k in ("xyz", "log_scale", "quat", "logit")}
    out["sh_dc"] = params["sh"][:, :1]
    out["sh_rest"] = params["sh"][:, 1:]
    return out


def loss_fn(gt: torch.Tensor, lambda_dssim: float):
    def f(image):
        l1 = (image - gt).abs().mean()
        return (1.0 - lambda_dssim) * l1 + lambda_dssim * (
            1.0 - R.ssim(image, gt))
    return f


def train_steps(params: dict, cams: list, photos: list, bg: torch.Tensor,
                opt: dict, first_iteration: int, spatial_lr_scale: float,
                v_rms: dict = None, dtype=torch.float32, loss=loss_fn) -> dict:
    """Three-step (or ``len(cams)``-step) follow of the training from
    ``params`` with Adam's first moment at zero, its second at
    ``v_rms[group]**2`` (zero without ``v_rms``) and its step count at
    ``first_iteration - 1``: iteration ``first_iteration + j`` trains on
    ``cams[j]`` against ``photos[j]`` ([3, H, W] in [0, 1]). Returns the
    losses, the first step's gradient norm per group and the change of
    each group over the steps, its norm per group. ``dtype`` is the
    precision of the whole computation; ``loss(gt, lambda_dssim)`` makes
    the loss of an image (``loss_fn``)."""
    with R.fp32():
        return _train_steps(params, cams, photos, bg, opt, first_iteration,
                            spatial_lr_scale, v_rms, dtype, loss)


def _train_steps(params, cams, photos, bg, opt, first_iteration,
                 spatial_lr_scale, v_rms, dtype, loss_of) -> dict:
    p = {k: v.detach().to(dtype).clone() for k, v in split(
        {"xyz": params["xyz"], "sh": params["sh"],
         "log_scale": params["log_scale"], "quat": params["quat"],
         "logit": params["logit"]}).items()}
    start = {k: v.clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.full_like(v, (v_rms or {}).get(k, 0.0) ** 2)
          for k, v in p.items()}
    losses, first_grad = [], None
    for j, (cam, gt) in enumerate(zip(cams, photos)):
        it = first_iteration + j
        leaves = {k: t.detach().requires_grad_(True) for k, t in p.items()}
        full = {"xyz": leaves["xyz"], "log_scale": leaves["log_scale"],
                "quat": leaves["quat"], "logit": leaves["logit"],
                "sh": torch.cat([leaves["sh_dc"], leaves["sh_rest"]], 1)}
        cam = cam._replace(R=cam.R.to(dtype), t=cam.t.to(dtype),
                           center=cam.center.to(dtype))
        loss, _ = R.render_backward(full, cam, bg.to(dtype),
                                    loss_of(gt.to(dtype), opt["lambda_dssim"]))
        losses.append(float(loss))
        grads = {k: (t.grad if t.grad is not None else torch.zeros_like(t))
                 for k, t in leaves.items()}
        if first_grad is None:
            first_grad = {k: float(g.float().norm()) for k, g in grads.items()}
        lrs = group_lrs(opt, it, spatial_lr_scale)
        step = it                       # Adam's count: one per iteration
        bc1 = 1.0 - B1 ** step
        bc2 = 1.0 - B2 ** step
        with torch.no_grad():
            for k in p:
                g = grads[k]
                m[k] = B1 * m[k] + (1 - B1) * g
                v2[k] = B2 * v2[k] + (1 - B2) * g * g
                p[k] = p[k] - lrs[k] * (m[k] / bc1) / (
                    torch.sqrt(v2[k] / bc2) + EPS)
        del leaves, full, grads
    change = {k: float((p[k].float() - start[k].float()).norm()) for k in p}
    return {"losses": losses, "grad_norm": first_grad, "change_norm": change}


def worst_gap(program: dict, reference: dict) -> tuple[float, str]:
    """The largest gap between two sets of per-group norms, each against
    the reference's norm of that group or the median group's, whichever is
    larger; groups whose reference norm is under a thousandth of the
    median's are left out (their values move by rounding alone)."""
    med = float(np.median(list(reference.values())))
    worst, at = 0.0, ""
    for k, ref in reference.items():
        if ref < 1e-3 * med:
            continue
        gap = abs(program[k] - ref) / max(ref, med)
        if gap > worst:
            worst, at = gap, k
    return worst, at
