"""Live-frame ingestion: stream frames -> SceneInfo (cameras + point init) —
the port's copy of ``gs_tpu/io_live/ingest.py``.

Behavioral port of the reference's ROS scene bootstrap
(ref: scene/dataset_readers.py:311-448 initCameraIntrinsics /
initCameraExtrinsics / initSceneInfo and scene/__init__.py:117-131
initROSCameras): intrinsics from the first frame's K, extrinsics from the
pose quaternions, images saved as JPEGs into the model dir, RAIN-GS-style
random init point cloud (or the frames' local maps), train/test split,
NeRF++ extent.
"""
from __future__ import annotations

import os
from typing import Sequence

import numpy as np

from ..core.camera import focal2fov
from ..data.dataset_readers import (CameraInfo, SceneInfo, get_nerfpp_norm,
                                    random_init_pointcloud)
from ..data.ply import store_pointcloud
from .stream import Frame


def qvec2rotmat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * y * y - 2 * z * z, 2 * x * y - 2 * w * z, 2 * x * z + 2 * w * y],
        [2 * x * y + 2 * w * z, 1 - 2 * x * x - 2 * z * z, 2 * y * z - 2 * w * x],
        [2 * x * z - 2 * w * y, 2 * y * z + 2 * w * x, 1 - 2 * x * x - 2 * y * y]])


def frame_camera_info(idx: int, frame: Frame, image_dir: str) -> CameraInfo:
    """One stream frame -> CameraInfo + saved JPEG
    (ref: dataset_readers.py:328-347 initCameraExtrinsics + :349-398)."""
    h, w = frame.image.shape[:2]
    fx, fy = frame.K[0, 0], frame.K[1, 1]
    fovx = focal2fov(fx, w)
    fovy = focal2fov(fy, h)

    R_pose = qvec2rotmat(frame.qvec)
    t_pose = np.asarray(frame.tvec, np.float64)
    if frame.pose_convention == "c2w":
        # invert to COLMAP world->cam (ref: convert_visual_merged_msg.py:608-624)
        Rwc = R_pose.T
        tvec = -Rwc @ t_pose
    else:
        Rwc = R_pose
        tvec = t_pose
    R = Rwc.T    # loaders store the transpose ("due to glm")

    name = f"frame_{idx:05d}"
    path = os.path.join(image_dir, name + ".jpg")
    from PIL import Image
    os.makedirs(image_dir, exist_ok=True)
    Image.fromarray(frame.image).save(path, quality=95)
    return CameraInfo(uid=idx, R=R, T=tvec, fovx=fovx, fovy=fovy,
                      image_path=path, image_name=name, width=w, height=h)


def scene_info_from_frames(frames: Sequence[Frame], work_dir: str, *,
                           eval_split: bool = True, llffhold: int = 8,
                           init_points: int = 100,
                           use_local_maps: bool = False,
                           seed: int = 0) -> SceneInfo:
    """Frames -> SceneInfo with a random (RAIN-GS) or local-map point init
    (ref: dataset_readers.py:349-448 initSceneInfo)."""
    if not frames:
        raise ValueError("no frames received")
    image_dir = os.path.join(work_dir, "images")
    cam_infos = [frame_camera_info(i, f, image_dir)
                 for i, f in enumerate(frames)]

    if eval_split:
        train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
        test = [c._replace(is_test=True) for i, c in enumerate(cam_infos)
                if i % llffhold == 0]
    else:
        train, test = cam_infos, []

    norm = get_nerfpp_norm(train if train else cam_infos)

    ply_path = os.path.join(work_dir, "points3d.ply")
    clouds = [f.points for f in frames if f.points is not None]
    if use_local_maps and clouds:
        xyz = np.concatenate(clouds, axis=0).astype(np.float32)
        rgb = np.full_like(xyz, 0.5)
    else:
        xyz, rgb, _ = random_init_pointcloud(cam_infos, init_points, seed)
    store_pointcloud(ply_path, xyz, rgb)
    pcd = (xyz, rgb, np.zeros_like(xyz))

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=norm, ply_path=ply_path,
                     is_nerf_synthetic=False)
