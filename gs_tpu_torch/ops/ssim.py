"""SSIM — port of ``gs_tpu/ops/ssim.py`` (ref: utils/loss_utils.py:100-159).

11x11 Gaussian window, sigma=1.5, per-channel same-padded blur, C1=0.01^2,
C2=0.03^2. :func:`ssim` runs the kernel pair of ``csrc/ssim.cu`` on CUDA
tensors and its twin, :func:`ssim_plain`, elsewhere.

The twin is the JAX package's formula: the separable blur as 11 shifted
multiply-adds per axis, summed in the same order, in float32. It needs no
convolution, so cuDNN's TF32 default cannot touch it, and it is exact
where the reference's SSIM is held to ~1e-6. The five blurred quantities
go through one blur as a stacked [15, H, W] tensor. Differentiable in both
inputs through autograd.

The kernel pair (wrappers :func:`ssim_fwd` and :func:`ssim_bwd`, each
counting its calls in ``launches``) replaces no Pallas kernel: the JAX
package's SSIM is jnp, which XLA fuses. Run eagerly, the twin is some
forty elementwise passes over the frame and as many again in autograd's
backward; the pair reads both images and writes three derivative maps, then
reads the maps and writes the gradient, so what bounds it is the stencil's
shared-memory work, far from the ~0.04 ms of bytes or of operations at a
1.09 MP frame. The forward's map is the twin's bit for bit and its mean is
summed in a fixed order, so a result is the same bits from run to run.
Like the reference's fused-ssim, the pair differentiates the first image
only: on CUDA a call whose second image requires a gradient raises.
:func:`ssim_backward_plain` is the backward kernel's twin, the same
formula in PyTorch.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda

C1 = 0.01 ** 2
C2 = 0.03 ** 2
WINDOW = 11            # the kernels' window, the only size they take
SOURCE = "ssim.cu"
_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _gaussian_window(window_size: int = 11, sigma: float = 1.5) -> np.ndarray:
    xs = np.arange(window_size, dtype=np.float64)
    g = np.exp(-((xs - window_size // 2) ** 2) / (2.0 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


# the kernels' taps: the twin's window
_TAPS = (ctypes.c_float * WINDOW)(*_gaussian_window(WINDOW).tolist())


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


def _moments(img1: torch.Tensor, img2: torch.Tensor,
             window_size: int = 11) -> tuple:
    """blur(x), blur(y), blur(x^2), blur(y^2), blur(xy) of x = img1 and
    y = img2, each [C, H, W], through one blur of the stacked five."""
    blurred = _blur(torch.cat([img1, img2, img1 * img1, img2 * img2,
                               img1 * img2], dim=0),
                    _gaussian_window(window_size))
    return torch.split(blurred, img1.shape[0], dim=0)


def ssim_plain(img1: torch.Tensor, img2: torch.Tensor,
               window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0,1]: the twin, on any
    device."""
    mu1, mu2, s11, s22, s12 = _moments(img1, img2, window_size)
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = s11 - mu1_sq
    sigma2_sq = s22 - mu2_sq
    sigma12 = s12 - mu1_mu2
    ssim_map = (((2 * mu1_mu2 + C1) * (2 * sigma12 + C2)) /
                ((mu1_sq + mu2_sq + C1) * (sigma1_sq + sigma2_sq + C2)))
    return torch.mean(ssim_map)


def _derivatives(mu1, mu2, s11, s22, s12) -> tuple:
    """The map's derivatives in blur(x), blur(x^2) and blur(xy), the
    kernel's three saved maps: (dmu, ds11, ds12)."""
    mu1_sq = mu1 * mu1
    mu2_sq = mu2 * mu2
    mu1_mu2 = mu1 * mu2
    sigma1_sq = s11 - mu1_sq
    sigma2_sq = s22 - mu2_sq
    sigma12 = s12 - mu1_mu2
    a = 2 * mu1_mu2 + C1
    b = 2 * sigma12 + C2
    c = mu1_sq + mu2_sq + C1
    d = sigma1_sq + sigma2_sq + C2
    cd = c * d
    m = (a * b) / cd
    ds11 = -m / d                  # dm/dsigma1^2
    ds12 = 2 * a / cd              # dm/dsigma12
    # dm/dmu1 with the sigma terms folded in
    dmu = 2 * mu2 * b / cd - 2 * mu1 * m / c - 2 * mu1 * ds11 - mu2 * ds12
    return dmu, ds11, ds12


def ssim_backward_plain(grad: torch.Tensor, img1: torch.Tensor,
                        img2: torch.Tensor) -> torch.Tensor:
    """The gradient in ``img1`` of ``grad`` x the mean SSIM: the backward
    kernel's twin, (grad / N) (blur(dmu) + 2 img1 blur(ds11) + img2
    blur(ds12)), N = C H W; the window is symmetric and zero-padded, so the
    blur is its own transpose."""
    maps = _derivatives(*_moments(img1, img2))
    b_mu, b11, b12 = torch.split(
        _blur(torch.cat(maps, dim=0), _gaussian_window(WINDOW)),
        img1.shape[0], dim=0)
    return (grad / img1.numel()) * (b_mu + 2 * img1 * b11 + img2 * b12)


def _image(t: torch.Tensor, name: str, like=None) -> int:
    if t.dim() != 3:
        raise ValueError(f"{name} must be [C, H, W], got {tuple(t.shape)}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if t.device.type != "cuda":
        raise ValueError(f"the SSIM kernels run on cuda, not {t.device}")
    if like is not None and (t.shape != like.shape or t.device != like.device):
        raise ValueError(f"{name} must be {tuple(like.shape)} on "
                         f"{like.device}, got {tuple(t.shape)} on {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    return t.data_ptr()


def _partials(c: int, h: int, w: int) -> int:
    fn = _cuda.function(SOURCE, "gs_ssim_partials", [_INT] * 3)
    n = fn(c, h, w)
    if n <= 0:
        raise ValueError(f"the SSIM kernels take 0 < C < 2^16, H, W > 0 and "
                         f"C H W < 2^31, got {c} x {h} x {w}")
    return n


def ssim_fwd(img1: torch.Tensor, img2: torch.Tensor, maps: bool = False):
    """The forward kernel: (the mean SSIM, a 0-d tensor; the [3, C, H, W]
    derivative maps (dmu, ds11, ds12) the backward reads, or None unless
    ``maps``)."""
    x = _image(img1, "img1")
    y = _image(img2, "img2", img1)
    dev = img1.device
    c, h, w = img1.shape
    partial = torch.empty(_partials(c, h, w), dtype=torch.float32, device=dev)
    value = torch.empty((), dtype=torch.float32, device=dev)
    out = (torch.empty((3, c, h, w), dtype=torch.float32, device=dev)
           if maps else None)
    ptrs = [None] * 3 if out is None else [m.data_ptr() for m in out]
    fn = _cuda.function(SOURCE, "gs_ssim_fwd",
                        [_PTR] * 8 + [_INT] * 4 + [_PTR])
    err = fn(x, y, *ptrs, partial.data_ptr(), value.data_ptr(), _TAPS,
             c, h, w, dev.index, _cuda.stream_ptr(dev))
    _cuda.check(SOURCE, err, "ssim_fwd")
    ssim_fwd.launches += 1
    return value, out


def ssim_bwd(grad: torch.Tensor, img1: torch.Tensor, img2: torch.Tensor,
             maps: torch.Tensor) -> torch.Tensor:
    """The backward kernel: the gradient in ``img1`` of ``grad`` (0-d) x
    the mean SSIM, from the forward's ``maps``."""
    x = _image(img1, "img1")
    y = _image(img2, "img2", img1)
    dev = img1.device
    c, h, w = img1.shape
    if (maps.dtype != torch.float32 or maps.device != dev
            or tuple(maps.shape) != (3, c, h, w) or not maps.is_contiguous()):
        raise ValueError(f"maps must be a contiguous float32 [3, {c}, {h}, "
                         f"{w}] on {dev}")
    if (grad.dtype != torch.float32 or grad.numel() != 1
            or grad.device != dev):
        raise ValueError(f"grad must be one float32 on {dev}")
    grad = grad.reshape(()).contiguous()
    out = torch.empty((c, h, w), dtype=torch.float32, device=dev)
    fn = _cuda.function(SOURCE, "gs_ssim_bwd",
                        [_PTR] * 8 + [_FLT] + [_INT] * 4 + [_PTR])
    err = fn(grad.data_ptr(), x, y, *[m.data_ptr() for m in maps],
             out.data_ptr(), _TAPS, float(np.float32(img1.numel())), c, h, w,
             dev.index, _cuda.stream_ptr(dev))
    _cuda.check(SOURCE, err, "ssim_bwd")
    ssim_bwd.launches += 1
    return out


ssim_fwd.launches = 0
ssim_bwd.launches = 0


class _SSIM(torch.autograd.Function):
    """The kernel pair under autograd: the gradient in img1 alone."""

    @staticmethod
    def forward(ctx, img1, img2):
        value, maps = ssim_fwd(img1, img2, maps=True)
        ctx.save_for_backward(img1, img2, maps)
        return value

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad):
        img1, img2, maps = ctx.saved_tensors
        return ssim_bwd(grad, img1, img2, maps), None


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM of two [C, H, W] images in [0,1]. On CUDA tensors the
    kernel pair (it raises where it cannot run: another window, another
    dtype or shape, or a second image that requires a gradient); on the
    CPU the twin."""
    if not (img1.is_cuda or img2.is_cuda):
        return ssim_plain(img1, img2, window_size)
    if window_size != WINDOW:
        raise ValueError(f"the SSIM kernels take a {WINDOW}-tap window, not "
                         f"{window_size}")
    grad_on = torch.is_grad_enabled()
    if grad_on and img2.requires_grad:
        raise ValueError("the SSIM kernels differentiate img1 only; img2 "
                         "requires a gradient")
    img1, img2 = img1.contiguous(), img2.contiguous()
    if grad_on and img1.requires_grad:
        return _SSIM.apply(img1, img2)
    return ssim_fwd(img1, img2)[0]
