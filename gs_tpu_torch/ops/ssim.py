"""SSIM — port of ``gs_tpu/ops/ssim.py`` (ref: utils/loss_utils.py:100-159).

11x11 Gaussian window, sigma=1.5, per-channel same-padded blur, C1=0.01^2,
C2=0.03^2. The separable blur is the JAX package's: 11 shifted
multiply-adds per axis, summed in the same order, in float32. It needs no
convolution, so cuDNN's TF32 default cannot touch it, and it is exact
where the reference's SSIM is held to ~1e-6. The five blurred quantities
go through one blur as a stacked [15, H, W] tensor. Differentiable in both
inputs through autograd.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

C1 = 0.01 ** 2
C2 = 0.03 ** 2


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, win: np.ndarray, axis: int) -> torch.Tensor:
    """Same-padded 1-D correlation along ``axis`` (1 or 2 of [C, H, W]) as
    K shifted multiply-adds."""
    k = win.shape[0]
    pad = k // 2
    n = x.shape[axis]
    xp = F.pad(x, (pad, pad) if axis == 2 else (0, 0, pad, pad))
    out = None
    for i in range(k):
        term = float(win[i]) * xp.narrow(axis, i, n)
        out = term if out is None else out + term
    return out


def _blur(img: torch.Tensor, win: np.ndarray) -> torch.Tensor:
    """Separable same-padded Gaussian blur; img [C, H, W]."""
    return _blur_axis(_blur_axis(img, win, 1), win, 2)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0,1]."""
    win = _gaussian_window(window_size)
    c = img1.shape[0]
    blurred = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2,
                               img1 * img2], dim=0), win)
    mu1, mu2, s11, s22, s12 = torch.split(blurred, c, dim=0)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = s11 - mu1_sq
    sigma2_sq = s22 - mu2_sq
    sigma12 = s12 - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) /
                ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return torch.mean(ssim_map)
