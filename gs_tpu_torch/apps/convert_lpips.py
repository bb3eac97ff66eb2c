"""One-command LPIPS weight conversion — port of
``gs_tpu/apps/convert_lpips.py``: torch checkpoints -> the npz both packages
load.

The reference's vendored lpipsPyTorch downloads its weights at runtime
(torchvision vgg16 features + the richzhang v0.1 ``vgg.pth`` linear heads,
ref: lpipsPyTorch/modules/networks.py:50-60). Here they are read from a
local ``.npz`` instead (``ops/lpips.py``). Given the two torch files:

    python -m gs_tpu_torch.apps.convert_lpips --vgg vgg16-397923af.pth --lin vgg.pth

writes ``~/.cache/gs_tpu/lpips_vgg.npz`` (override with -o or
``$GS_TPU_LPIPS_WEIGHTS``), after which the metrics CLI reports LPIPS.
``--check`` then scores a random pair and an identical one on
``--data_device`` (``cuda`` by default).

Where to get the inputs (on a machine with network access):
  vgg16:  https://download.pytorch.org/models/vgg16-397923af.pth
  lin:    https://github.com/richzhang/PerceptualSimilarity/raw/master/
          lpips/weights/v0.1/vgg.pth
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.lpips import convert_torch_weights, default_weights_path, lpips_vgg
from .args import resolve_data_device


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--vgg", required=True,
                   help="torchvision vgg16 state_dict .pth")
    p.add_argument("--lin", required=True,
                   help="richzhang LPIPS v0.1 vgg.pth (linear heads)")
    p.add_argument("-o", "--out", default=None,
                   help="output npz (default: $GS_TPU_LPIPS_WEIGHTS or "
                        "~/.cache/gs_tpu/lpips_vgg.npz)")
    p.add_argument("--check", action="store_true",
                   help="after writing, score a random pair and an "
                        "identical one")
    p.add_argument("--data_device", default="cuda",
                   help="device of the --check scoring")
    args = p.parse_args(argv)

    out = args.out or default_weights_path()
    convert_torch_weights(args.vgg, args.lin, out)
    print(f"wrote {out}")

    if args.check:
        device = resolve_data_device(args.data_device)
        f = lpips_vgg(out, device=device)
        rng = np.random.default_rng(0)
        a = rng.uniform(0, 1, (3, 64, 64)).astype(np.float32)
        b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
        ta, tb = (torch.from_numpy(x).to(device) for x in (a, b))
        print(f"self-check: lpips(random pair) = {float(f(ta, tb)):.6f} "
              f"(identical pair = {float(f(ta, ta)):.2e})")


if __name__ == "__main__":
    main()
