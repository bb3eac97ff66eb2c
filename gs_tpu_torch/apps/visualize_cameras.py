"""Camera-frustum plot — port of ``gs_tpu/apps/visualize_cameras.py``, the
reference's pose-sanity script (ref: visualize_view.py:1-67): reads COLMAP
images.txt/bin poses and plots camera frusta in 3D so pose-conversion bugs
are visible at a glance. Matplotlib is imported when the plot is drawn.

Usage: ``python -m gs_tpu_torch.apps.visualize_cameras -s <dataset> [-o out.png]``
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..data import colmap


def frustum_lines(Rwc: np.ndarray, tvec: np.ndarray, scale: float = 0.3):
    """Five frustum points (apex + 4 image corners) in world space."""
    C = -Rwc.T @ tvec
    corners = np.array([[-1, -0.75, 1.5], [1, -0.75, 1.5],
                        [1, 0.75, 1.5], [-1, 0.75, 1.5]]) * scale
    world = (Rwc.T @ corners.T).T + C
    return C, world


def main(argv=None):
    parser = argparse.ArgumentParser(description="Camera frusta plot")
    parser.add_argument("--source_path", "-s", required=True)
    parser.add_argument("--output", "-o", default="cameras.png")
    parser.add_argument("--scale", type=float, default=0.3)
    args = parser.parse_args(argv)

    sparse = os.path.join(args.source_path, "sparse", "0")
    try:
        images = colmap.read_extrinsics_binary(
            os.path.join(sparse, "images.bin"))
    except (FileNotFoundError, IOError):
        images = colmap.read_extrinsics_text(
            os.path.join(sparse, "images.txt"))

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = plt.figure(figsize=(10, 10))
    ax = fig.add_subplot(projection="3d")
    centers = []
    for im in images.values():
        Rwc = colmap.qvec2rotmat(im.qvec)
        C, corners = frustum_lines(Rwc, im.tvec, args.scale)
        centers.append(C)
        for c in corners:
            ax.plot(*zip(C, c), color="steelblue", linewidth=0.5)
        loop = np.vstack([corners, corners[:1]])
        ax.plot(loop[:, 0], loop[:, 1], loop[:, 2], color="steelblue",
                linewidth=0.5)
    centers = np.stack(centers)
    ax.scatter(centers[:, 0], centers[:, 1], centers[:, 2],
               color="crimson", s=8)
    ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
    ax.set_title(f"{len(images)} cameras — {args.source_path}")
    fig.savefig(args.output, dpi=120, bbox_inches="tight")
    plt.close(fig)
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
