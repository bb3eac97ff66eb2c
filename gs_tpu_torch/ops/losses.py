"""Loss and image-metric primitives — port of ``gs_tpu/ops/losses.py``
(ref: utils/loss_utils.py:40-66, utils/image_utils.py:14-19)."""
from __future__ import annotations

import torch


def l1_loss(x, gt):
    return torch.mean(torch.abs(x - gt))


def l2_loss(x, gt):
    return torch.mean((x - gt) ** 2)


def mse(img1, img2):
    """Per-image MSE, inputs [B, ...]. ref: utils/image_utils.py:14-15"""
    d = (img1 - img2) ** 2
    return d.reshape(d.shape[0], -1).mean(dim=1, keepdim=True)


def psnr(img1, img2):
    """Per-image PSNR = 20 log10(1/sqrt(MSE)). ref: utils/image_utils.py:17-19"""
    m = mse(img1, img2)
    return 20.0 * torch.log10(1.0 / torch.sqrt(m))
