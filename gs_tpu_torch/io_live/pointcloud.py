"""Point-cloud preprocessing utilities (numpy; scipy's cKDTree imported where
it is used; no Open3D) — the port's copy of ``gs_tpu/io_live/pointcloud.py``.

Behavioral equivalents of the reference's ROS pointcloud nodes
(ref: SURVEY.md §2.2 S5/S6 — pointcloud_pcd.py voxel downsample +
statistical outlier removal, pointcloud_aligner.py rigid transforms) and the
offline converter's merge pipeline (convert_visual_merged_msg.py:115-185).
"""
from __future__ import annotations

import numpy as np


def voxel_downsample(points: np.ndarray, voxel_size: float,
                     colors: np.ndarray = None):
    """Average points (and colors) per occupied voxel."""
    if len(points) == 0:
        return (points, colors) if colors is not None else points
    keys = np.floor(points / voxel_size).astype(np.int64)
    # unique voxel ids
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    out = np.zeros((len(counts), 3), np.float64)
    np.add.at(out, inv, points)
    out /= counts[:, None]
    if colors is not None:
        cout = np.zeros((len(counts), colors.shape[1]), np.float64)
        np.add.at(cout, inv, colors)
        cout /= counts[:, None]
        return out.astype(points.dtype), cout.astype(colors.dtype)
    return out.astype(points.dtype)


def remove_statistical_outliers(points: np.ndarray, nb_neighbors: int = 20,
                                std_ratio: float = 2.0,
                                sample_cap: int = 200_000):
    """Drop points whose mean k-NN distance exceeds mean + std_ratio * std
    (the Open3D remove_statistical_outlier contract used by S5)."""
    n = len(points)
    if n <= nb_neighbors + 1:
        return points, np.ones(n, bool)
    from scipy.spatial import cKDTree
    tree = cKDTree(points if n <= sample_cap else
                   points[np.random.default_rng(0).choice(n, sample_cap,
                                                          replace=False)])
    d, _ = tree.query(points, k=min(nb_neighbors + 1, n))
    mean_d = d[:, 1:].mean(axis=1)
    thresh = mean_d.mean() + std_ratio * mean_d.std()
    keep = mean_d <= thresh
    return points[keep], keep


def transform_points(points: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Apply a 4x4 rigid transform (ref: pointcloud_aligner.py)."""
    return points @ matrix[:3, :3].T + matrix[:3, 3]


def estimate_heading(positions: np.ndarray, n_first: int = 100) -> float:
    """Initial heading (yaw, radians) from the first displacement of a
    position track — the GPS-track alignment step
    (ref: convert_visual_merged_msg.py:505-529)."""
    pts = positions[:min(n_first, len(positions))]
    if len(pts) < 2:
        return 0.0
    disp = pts[-1] - pts[0]
    return float(np.arctan2(disp[1], disp[0]))


def rotation_z(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def rotation_x(angle: float) -> np.ndarray:
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])


def icp_point_to_point(source: np.ndarray, target: np.ndarray, *,
                       max_corr_dist: float, max_iterations: int = 50,
                       rel_rmse: float = 1e-6):
    """Rigid point-to-point ICP aligning ``source`` onto ``target``.

    Numpy/scipy equivalent of the reference's Open3D GPU ICP used to register
    successive local maps before merging (ref:
    convert_visual_merged_msg.py:393-432 — voxel-downsampled clouds,
    point-to-point estimation, max_correspondence_distance = 5 * voxel,
    up to 50 iterations, 1e-6 relative-RMSE convergence).

    Returns (T [4,4], rmse, n_inliers).
    """
    from scipy.spatial import cKDTree
    T = np.eye(4)
    src = source.astype(np.float64).copy()
    tree = cKDTree(target.astype(np.float64))
    prev_rmse = np.inf
    rmse, n_in = np.inf, 0
    for _ in range(max_iterations):
        dist, idx = tree.query(src, distance_upper_bound=max_corr_dist)
        ok = np.isfinite(dist)
        n_in = int(ok.sum())
        if n_in < 3:
            break
        p = src[ok]
        q = target[idx[ok]]
        rmse = float(np.sqrt(np.mean(dist[ok] ** 2)))
        if abs(prev_rmse - rmse) < rel_rmse * max(prev_rmse, 1e-12):
            break
        prev_rmse = rmse
        # Kabsch: least-squares rigid transform of correspondences
        pc, qc = p.mean(0), q.mean(0)
        H = (p - pc).T @ (q - qc)
        U, _, Vt = np.linalg.svd(H)
        d = np.sign(np.linalg.det(Vt.T @ U.T))
        R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
        t = qc - R @ pc
        src = src @ R.T + t
        step = np.eye(4)
        step[:3, :3] = R
        step[:3, 3] = t
        T = step @ T
    return T, rmse, n_in
