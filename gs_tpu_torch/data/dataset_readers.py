"""Scene loaders: COLMAP sparse models, NeRF-synthetic (Blender) JSON, and
random point-cloud initialization — the port's own copy of
``gs_tpu/data/dataset_readers.py`` (numpy, PIL lazily).

Behavioral port of the reference readers with the upstream-intended semantics
(ref: scene/dataset_readers.py:75-275; SURVEY.md §0.1 notes the snapshot's
merge breakages — this implements what the call sites expect):

* COLMAP: PINHOLE / SIMPLE_PINHOLE only, focal -> FoV, "R stored transposed
  due to glm" (ref: scene/dataset_readers.py:209), eval split = every
  ``llffhold``-th image of the name-sorted list (ref: :159-164),
  points3D.bin -> .ply conversion on first open (ref: :168-177).
* Blender: c2w OpenGL->COLMAP axis flip, white/black background choice, FoV
  from ``camera_angle_x``, random 100k-point init in [-1.3, 1.3]^3
  (ref: :191-275).
* getNerfppNorm: translate/radius = 1.1 x max camera-to-centroid distance
  (ref: :51-72).
"""
from __future__ import annotations

import json
import math
import os
import struct
from typing import NamedTuple, Optional

import numpy as np

from ..core.camera import focal2fov, fov2focal
from . import colmap
from .ply import fetch_pointcloud, store_pointcloud


class CameraInfo(NamedTuple):
    """Per-view metadata before image loading (ref: scene/dataset_readers.py:31-41
    plus the upstream depth/is_test fields the snapshot dropped)."""
    uid: int
    R: np.ndarray           # cam-to-world rotation (W2C rotation transposed)
    T: np.ndarray           # world-to-cam translation
    fovx: float
    fovy: float
    image_path: str
    image_name: str
    width: int
    height: int
    depth_path: str = ""
    depth_params: Optional[dict] = None
    is_test: bool = False


class SceneInfo(NamedTuple):
    point_cloud: tuple       # (xyz, rgb, normals)
    train_cameras: list
    test_cameras: list
    nerf_normalization: dict  # {"translate": [3], "radius": float}
    ply_path: str
    is_nerf_synthetic: bool = False


def get_nerfpp_norm(cam_infos: list[CameraInfo]) -> dict:
    """ref: scene/dataset_readers.py:51-72 (getNerfppNorm)."""
    centers = []
    for cam in cam_infos:
        W2C = np.zeros((4, 4))
        W2C[:3, :3] = cam.R.transpose()
        W2C[:3, 3] = cam.T
        W2C[3, 3] = 1.0
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3:4])
    centers = np.hstack(centers)
    avg = centers.mean(axis=1, keepdims=True)
    dist = np.linalg.norm(centers - avg, axis=0, keepdims=True)
    diagonal = float(dist.max())
    radius = diagonal * 1.1
    translate = -avg[:, 0]
    return {"translate": translate, "radius": radius}


# ----------------------------------------------------------------- COLMAP

def read_colmap_cameras(cam_extrinsics, cam_intrinsics, images_folder,
                        depths_folder="", depth_params=None,
                        test_names=frozenset()) -> list[CameraInfo]:
    """ref: scene/dataset_readers.py:75-112 (readColmapCameras)."""
    cam_infos = []
    for key in sorted(cam_extrinsics.keys()):
        extr = cam_extrinsics[key]
        intr = cam_intrinsics[extr.camera_id]
        height = intr.height
        width = intr.width
        R = np.transpose(colmap.qvec2rotmat(extr.qvec))
        T = np.array(extr.tvec)
        if intr.model == "SIMPLE_PINHOLE":
            focal_x = intr.params[0]
            fovx = focal2fov(focal_x, width)
            fovy = focal2fov(focal_x, height)
        elif intr.model == "PINHOLE":
            fovx = focal2fov(intr.params[0], width)
            fovy = focal2fov(intr.params[1], height)
        else:
            raise ValueError(
                "Colmap camera model not handled: only undistorted datasets "
                "(PINHOLE or SIMPLE_PINHOLE cameras) supported!")
        base = os.path.splitext(os.path.basename(extr.name))[0]
        image_path = os.path.join(images_folder, extr.name)
        depth_path = (os.path.join(depths_folder, base + ".png")
                      if depths_folder else "")
        dp = depth_params.get(base) if depth_params else None
        cam_infos.append(CameraInfo(
            uid=intr.id, R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=image_path, image_name=base,
            width=width, height=height, depth_path=depth_path,
            depth_params=dp, is_test=base in test_names))
    return cam_infos


def read_colmap_scene(path: str, images: str = "images", depths: str = "",
                      eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    """ref: scene/dataset_readers.py:140-189 (readColmapSceneInfo)."""
    sparse = os.path.join(path, "sparse", "0")
    try:
        cam_extr = colmap.read_extrinsics_binary(os.path.join(sparse, "images.bin"))
        cam_intr = colmap.read_intrinsics_binary(os.path.join(sparse, "cameras.bin"))
    except (FileNotFoundError, struct.error):
        cam_extr = colmap.read_extrinsics_text(os.path.join(sparse, "images.txt"))
        cam_intr = colmap.read_intrinsics_text(os.path.join(sparse, "cameras.txt"))

    depth_params = None
    dp_path = os.path.join(sparse, "depth_params.json")
    if depths and os.path.exists(dp_path):
        with open(dp_path) as f:
            depth_params = json.load(f)
        # med_scale reliability gating happens at load time (camera_utils)
        all_scales = np.array([d["scale"] for d in depth_params.values()])
        med_scale = float(np.median(all_scales[all_scales > 0])) \
            if (all_scales > 0).sum() else 0.0
        for d in depth_params.values():
            d["med_scale"] = med_scale

    # upstream also honours an explicit sparse/0/test.txt holdout list
    test_names = frozenset()
    test_txt = os.path.join(sparse, "test.txt")
    if eval_split and os.path.exists(test_txt):
        with open(test_txt) as f:
            test_names = frozenset(ln.strip() for ln in f if ln.strip())

    depths_folder = os.path.join(path, depths) if depths else ""
    cam_infos = read_colmap_cameras(
        cam_extr, cam_intr, os.path.join(path, images),
        depths_folder, depth_params, test_names)
    cam_infos = sorted(cam_infos, key=lambda c: c.image_name)

    if eval_split:
        if test_names:
            train = [c for c in cam_infos if not c.is_test]
            test = [c for c in cam_infos if c.is_test]
        else:
            # every llffhold-th image (ref: scene/dataset_readers.py:159-164)
            train = [c for i, c in enumerate(cam_infos) if i % llffhold != 0]
            test = [c._replace(is_test=True) for i, c in enumerate(cam_infos)
                    if i % llffhold == 0]
    else:
        train = cam_infos
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    bin_path = os.path.join(sparse, "points3D.bin")
    txt_path = os.path.join(sparse, "points3D.txt")
    if not os.path.exists(ply_path):
        # first open: convert points3D.bin -> .ply (ref: :168-177)
        print("Converting point3d.bin to .ply, will happen only the first "
              "time you open the scene.")
        try:
            xyz, rgb, _ = colmap.read_points3D_binary(bin_path)
        except FileNotFoundError:
            xyz, rgb, _ = colmap.read_points3D_text(txt_path)
        store_pointcloud(ply_path, xyz, rgb)
    pcd = fetch_pointcloud(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=norm, ply_path=ply_path,
                     is_nerf_synthetic=False)


# ---------------------------------------------------------------- Blender

def read_cameras_from_transforms(path: str, transformsfile: str,
                                 depths_folder: str, extension: str,
                                 is_test: bool) -> list[CameraInfo]:
    """ref: scene/dataset_readers.py:191-236 (readCamerasFromTransforms)."""
    from PIL import Image
    cam_infos = []
    with open(os.path.join(path, transformsfile)) as f:
        contents = json.load(f)
    fovx = contents["camera_angle_x"]
    for idx, frame in enumerate(contents["frames"]):
        cam_name = os.path.join(path, frame["file_path"] + extension)
        c2w = np.array(frame["transform_matrix"])
        # OpenGL/Blender -> COLMAP (Y down, Z forward) (ref: :211-213)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = np.transpose(w2c[:3, :3])   # "stored transposed due to glm"
        T = w2c[:3, 3]
        image_path = os.path.join(path, cam_name)
        image_name = os.path.splitext(os.path.basename(cam_name))[0]
        with Image.open(image_path) as im:
            width, height = im.size
        fovy = focal2fov(fov2focal(fovx, width), height)
        depth_path = (os.path.join(depths_folder, image_name + ".png")
                      if depths_folder else "")
        cam_infos.append(CameraInfo(
            uid=idx, R=R, T=T, fovx=fovx, fovy=fovy,
            image_path=image_path, image_name=image_name,
            width=width, height=height, depth_path=depth_path,
            depth_params=None, is_test=is_test))
    return cam_infos


def read_nerf_synthetic_scene(path: str, white_background: bool,
                              eval_split: bool, extension: str = ".png",
                              depths: str = "") -> SceneInfo:
    """ref: scene/dataset_readers.py:238-275 (readNerfSyntheticInfo)."""
    depths_folder = os.path.join(path, depths) if depths else ""
    print("Reading Training Transforms")
    train = read_cameras_from_transforms(
        path, "transforms_train.json", depths_folder, extension, False)
    print("Reading Test Transforms")
    test = read_cameras_from_transforms(
        path, "transforms_test.json", depths_folder, extension, True)
    if not eval_split:
        train = train + test
        test = []

    norm = get_nerfpp_norm(train)

    ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        num_pts = 100_000
        print(f"Generating random point cloud ({num_pts})...")
        xyz = np.random.random((num_pts, 3)) * 2.6 - 1.3  # ref: :262-266
        shs = np.random.random((num_pts, 3)) / 255.0
        from ..core.sh import C0
        store_pointcloud(ply_path, xyz, (shs * C0 + 0.5))
    pcd = fetch_pointcloud(ply_path)

    return SceneInfo(point_cloud=pcd, train_cameras=train, test_cameras=test,
                     nerf_normalization=norm, ply_path=ply_path,
                     is_nerf_synthetic=True)


def random_init_pointcloud(cam_infos: list[CameraInfo], num_points: int = 100,
                           seed: int = 0):
    """RAIN-GS-style random init: uniform points inside 3x the camera bbox
    (ref: scene/dataset_readers.py:400-432, live-SLAM path)."""
    rng = np.random.default_rng(seed)
    centers = []
    for cam in cam_infos:
        W2C = np.eye(4)
        W2C[:3, :3] = cam.R.transpose()
        W2C[:3, 3] = cam.T
        centers.append(np.linalg.inv(W2C)[:3, 3])
    centers = np.stack(centers)
    mid = centers.mean(axis=0)
    half = np.maximum((centers.max(axis=0) - centers.min(axis=0)) / 2, 1e-3)
    lo, hi = mid - 3 * half, mid + 3 * half
    xyz = rng.uniform(lo, hi, (num_points, 3)).astype(np.float32)
    rgb = rng.uniform(0, 1, (num_points, 3)).astype(np.float32)
    normals = np.zeros_like(xyz)
    return xyz, rgb, normals


def load_scene_info(source_path: str, images: str = "images", depths: str = "",
                    eval_split: bool = False, llffhold: int = 8) -> SceneInfo:
    """Dataset-type dispatch (ref: scene/__init__.py:48-52)."""
    if os.path.exists(os.path.join(source_path, "sparse")):
        return read_colmap_scene(source_path, images, depths, eval_split,
                                 llffhold)
    if os.path.exists(os.path.join(source_path, "transforms_train.json")):
        print("Found transforms_train.json file, assuming Blender data set!")
        return read_nerf_synthetic_scene(source_path,
                                         white_background=False,
                                         eval_split=eval_split,
                                         depths=depths)
    raise ValueError(f"Could not recognize scene type for {source_path}")
