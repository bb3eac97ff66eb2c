"""Model loading and image output shared by the port's CLIs — the
``params_from_ply`` and ``save_png`` of ``gs_tpu/apps/render.py``.

The dataset render CLI (``gs_tpu.apps.render.main``, which needs the
dataset loaders) is not ported yet.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.gaussians import GaussianParams


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
