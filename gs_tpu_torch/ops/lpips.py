"""LPIPS v0.1 (VGG16 backbone) — port of ``gs_tpu/ops/lpips.py``.

Behavioural port of the reference's self-contained lpipsPyTorch
(ref: lpipsPyTorch/modules/lpips.py, networks.py — VGG16 features at
relu1_2/relu2_2/relu3_3/relu4_3/relu5_3, channel-unit-normalized activations,
frozen 1x1 linear heads, input normalization shift/scale constants).

The weights come from the JAX package's local ``.npz`` layout (conv{i}_w
[O, I, 3, 3], conv{i}_b [O], lin{i} [1, C]), found by the same
``default_weights_path()``: ``$GS_TPU_LPIPS_WEIGHTS`` or
``~/.cache/gs_tpu/lpips_vgg.npz``, so one file serves both packages.
:func:`convert_torch_weights` writes it from the torchvision and richzhang
checkpoints. Without the file :func:`lpips_vgg` raises FileNotFoundError.

The convolutions are ``F.conv2d`` (cuDNN on the card), as the JAX package
computes them in XLA rather than in a Pallas kernel; they run with TF32 off,
inside ``torch.backends.cudnn.flags``, so no global switch is needed.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

# ref: lpipsPyTorch/modules/networks.py (ScalingLayer constants)
SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG16 conv layout: (out_channels per conv, 'M' = maxpool). Feature taps are
# taken right before each pool (relu1_2, relu2_2, relu3_3, relu4_3, relu5_3).
VGG16_CFG = [64, 64, "M", 128, 128, "M", 256, 256, 256, "M",
             512, 512, 512, "M", 512, 512, 512]
TAP_CHANNELS = [64, 128, 256, 512, 512]


def default_weights_path() -> str:
    return os.environ.get(
        "GS_TPU_LPIPS_WEIGHTS",
        os.path.expanduser("~/.cache/gs_tpu/lpips_vgg.npz"))


def convert_torch_weights(vgg_state_path: str, lin_state_path: str,
                          out_npz: str):
    """Convert torchvision vgg16 ``state_dict`` + richzhang vgg.pth lin heads
    (saved with torch.save) into the npz this module loads."""
    vgg = torch.load(vgg_state_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_state_path, map_location="cpu", weights_only=True)
    arrays = {}
    conv_idx = 0
    torch_layer = 0
    for c in VGG16_CFG:
        if c == "M":
            torch_layer += 1
            continue
        arrays[f"conv{conv_idx}_w"] = vgg[f"features.{torch_layer}.weight"].numpy()
        arrays[f"conv{conv_idx}_b"] = vgg[f"features.{torch_layer}.bias"].numpy()
        conv_idx += 1
        torch_layer += 2   # conv + relu
    for i in range(5):
        key = f"lin{i}.model.1.weight"
        arrays[f"lin{i}"] = lin[key].numpy()[:, :, 0, 0]  # [1, C]
    os.makedirs(os.path.dirname(os.path.abspath(out_npz)), exist_ok=True)
    np.savez(out_npz, **arrays)


def normalize_act(feat: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(feat ** 2, dim=1, keepdim=True))
    return feat / (norm + eps)


class LPIPS(torch.nn.Module):
    """The VGG16 trunk, its five taps and the five linear heads, frozen.
    ``forward(img1, img2)`` takes two [3, H, W] images in [0, 1] and returns
    the 0-d LPIPS distance."""

    def __init__(self, weights: dict, device="cuda"):
        super().__init__()

        def param(name):
            return torch.nn.Parameter(
                torch.tensor(np.asarray(weights[name], np.float32),
                             device=device), requires_grad=False)

        n_conv = sum(c != "M" for c in VGG16_CFG)
        self.conv_w = torch.nn.ParameterList(
            [param(f"conv{i}_w") for i in range(n_conv)])
        self.conv_b = torch.nn.ParameterList(
            [param(f"conv{i}_b") for i in range(n_conv)])
        self.lin = torch.nn.ParameterList([param(f"lin{i}") for i in range(5)])
        self.register_buffer("shift", torch.tensor(SHIFT, device=device)
                             .reshape(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE, device=device)
                             .reshape(1, 3, 1, 1))

    def features(self, x: torch.Tensor) -> list[torch.Tensor]:
        """x: [1, 3, H, W] normalized; returns the 5 tap activations."""
        taps = []
        conv_idx = 0
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            for c in VGG16_CFG:
                if c == "M":
                    taps.append(x)
                    x = F.max_pool2d(x, 2, 2)
                    continue
                x = F.relu(F.conv2d(x, self.conv_w[conv_idx],
                                    self.conv_b[conv_idx], padding=1))
                conv_idx += 1
        taps.append(x)
        return taps

    def z_score(self, img: torch.Tensor) -> torch.Tensor:
        # the reference's vendored lpipsPyTorch z-scores the RAW input
        # (networks.py BaseNet.z_score: (x - shift) / scale, no internal
        # [-1,1] rescale), and metrics.py:74 passes [0,1] images
        return (img[None] - self.shift) / self.scale

    @torch.no_grad()
    def forward(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        f1 = self.features(self.z_score(img1))
        f2 = self.features(self.z_score(img2))
        total = torch.zeros((), device=img1.device)
        for i, (a, b) in enumerate(zip(f1, f2)):
            d = (normalize_act(a) - normalize_act(b)) ** 2      # [1,C,H,W]
            weighted = (d * self.lin[i][0][None, :, None, None]).sum(1)
            total = total + torch.mean(weighted)
        return total


def lpips_vgg(weights_path: str | None = None, device="cuda") -> LPIPS:
    """The LPIPS module on ``device``, from the weights npz (default
    ``default_weights_path()``). Raises FileNotFoundError when it is
    absent."""
    path = weights_path or default_weights_path()
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"LPIPS weights not found at {path}; set GS_TPU_LPIPS_WEIGHTS or "
            "run gs_tpu_torch.apps.convert_lpips on the torch checkpoints")
    with np.load(path) as loaded:
        weights = {k: loaded[k] for k in loaded.files}
    return LPIPS(weights, device=device).eval()
