"""gs_tpu_torch's data layer against gs_tpu's on the CPU: the COLMAP (binary
and text) and Blender readers, Scene (cameras, cameras.json, input.ply,
images, PLY snapshots), the resolution policy and the COLMAP binary
writer/reader pair, on the synthetic datasets of tests/test_data.py."""
import json
import os
import random

import numpy as np
import pytest
import torch

from gs_tpu.data import dataset_readers as jdr
from gs_tpu.data.camera_utils import resolve_resolution as jax_resolve_resolution
from gs_tpu.data.scene import Scene as JScene

from gs_tpu_torch.core.camera import Camera
from gs_tpu_torch.data import colmap
from gs_tpu_torch.data import dataset_readers as tdr
from gs_tpu_torch.data.camera_utils import resolve_resolution
from gs_tpu_torch.data.scene import Scene
from gs_tpu_torch.models.gaussian_model import create_from_pcd

from test_data import make_blender_dataset, make_colmap_dataset

CAM_FIELDS = ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy")


def assert_infos_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert (a.uid, a.image_name, a.image_path, a.width, a.height,
                a.is_test, a.depth_path) == (b.uid, b.image_name,
                                             b.image_path, b.width, b.height,
                                             b.is_test, b.depth_path)
        np.testing.assert_array_equal(a.R, b.R)
        np.testing.assert_array_equal(a.T, b.T)
        assert (a.fovx, a.fovy) == (b.fovx, b.fovy)


def assert_scene_infos_equal(got, ref):
    assert_infos_equal(got.train_cameras, ref.train_cameras)
    assert_infos_equal(got.test_cameras, ref.test_cameras)
    for a, b in zip(got.point_cloud, ref.point_cloud):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(got.nerf_normalization["translate"],
                                  ref.nerf_normalization["translate"])
    assert got.nerf_normalization["radius"] == ref.nerf_normalization["radius"]
    assert (got.ply_path, got.is_nerf_synthetic) == (ref.ply_path,
                                                     ref.is_nerf_synthetic)


@pytest.mark.parametrize("binary", [True, False])
@pytest.mark.parametrize("eval_split", [True, False])
def test_colmap_scene_matches_jax(tmp_path, rng, binary, eval_split):
    root = str(tmp_path / "scene")
    make_colmap_dataset(root, rng, binary=binary)
    ref = jdr.read_colmap_scene(root, eval_split=eval_split, llffhold=4)
    got = tdr.read_colmap_scene(root, eval_split=eval_split, llffhold=4)
    assert_scene_infos_equal(got, ref)
    assert len(got.test_cameras) == (3 if eval_split else 0)


def test_blender_scene_matches_jax(tmp_path, rng):
    root = str(tmp_path / "nerf")
    make_blender_dataset(root, rng)
    ref = jdr.read_nerf_synthetic_scene(root, white_background=True,
                                        eval_split=True)
    got = tdr.read_nerf_synthetic_scene(root, white_background=True,
                                        eval_split=True)
    assert_scene_infos_equal(got, ref)
    assert_scene_infos_equal(tdr.load_scene_info(root),
                             jdr.load_scene_info(root))


def test_random_init_pointcloud_matches_jax(tmp_path, rng):
    root = str(tmp_path / "scene")
    make_colmap_dataset(root, rng)
    infos = tdr.read_colmap_scene(root).train_cameras
    for a, b in zip(tdr.random_init_pointcloud(infos, 100, seed=3),
                    jdr.random_init_pointcloud(infos, 100, seed=3)):
        np.testing.assert_array_equal(a, b)


def test_scene_matches_jax(tmp_path, rng):
    root = str(tmp_path / "scene")
    make_colmap_dataset(root, rng)
    random.seed(5)
    ref = JScene(root, str(tmp_path / "jax"), eval_split=True,
                 train_test_exp=True)
    random.seed(5)
    got = Scene(root, str(tmp_path / "torch"), eval_split=True,
                train_test_exp=True, device="cpu")
    assert got.cameras_extent == ref.cameras_extent
    for name in ("cameras.json", "input.ply"):
        with open(tmp_path / "jax" / name, "rb") as a, \
                open(tmp_path / "torch" / name, "rb") as b:
            assert a.read() == b.read(), name
    for split in ("get_train_cameras", "get_test_cameras"):
        g, r = getattr(got, split)(), getattr(ref, split)()
        assert len(g) == len(r) > 0
        for a, b in zip(g, r):
            assert isinstance(a.camera, Camera)
            assert a.camera.device == torch.device("cpu")
            assert a.info.image_name == b.info.image_name
            for k in CAM_FIELDS:
                np.testing.assert_array_equal(
                    getattr(a.camera, k).numpy(), np.asarray(getattr(b.camera, k)))
            assert (a.camera.width, a.camera.height) == (b.camera.width,
                                                         b.camera.height)
            for k in ("image", "alpha_mask"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k))

    # snapshots and exposure.json in the model-dir layout
    params, alive = create_from_pcd(*got.point_cloud[:2], sh_degree=2,
                                    capacity=128, device="cpu")
    exposure = torch.arange(len(got.get_train_cameras()) * 12,
                            dtype=torch.float32).reshape(-1, 3, 4)
    got.save(77, params, alive, exposure=exposure)
    ref.save(77, params._replace(**{k: v.numpy() for k, v
                                    in params._asdict().items()}),
             alive.numpy(), exposure=exposure.numpy())
    for rel in (("exposure.json",),
                ("point_cloud", "iteration_77", "point_cloud.ply")):
        with open(tmp_path.joinpath("jax", *rel), "rb") as a, \
                open(tmp_path.joinpath("torch", *rel), "rb") as b:
            assert a.read() == b.read(), rel
    d, it = got.load_ply(-1)
    assert it == 77 and d["xyz"].shape[0] == int(alive.sum())
    with open(tmp_path / "torch" / "exposure.json") as f:
        assert len(json.load(f)) == 10


@pytest.mark.parametrize("size, resolution", [
    ((3200, 2400), -1), ((1600, 1200), -1), ((1600, 1200), 2),
    ((1600, 1200), 8), ((1600, 1200), 800), ((1920, 1080), 1),
    ((1920, 1080), -1)])
def test_resolve_resolution_matches_jax(size, resolution):
    assert resolve_resolution(*size, resolution) == \
        jax_resolve_resolution(*size, resolution)


def test_points3d_binary_round_trip(tmp_path, rng):
    path = str(tmp_path / "points3D.bin")
    xyz = rng.uniform(-5, 5, (300, 3))
    rgb = rng.integers(0, 256, (300, 3)).astype(np.uint8)
    err = rng.uniform(0, 1, (300, 1))
    colmap.write_points3D_binary(xyz, rgb, err, path)
    got = colmap.read_points3D_binary(path)
    for a, b in zip(got, (xyz, rgb, err)):
        np.testing.assert_array_equal(a, b)
    assert got[1].dtype == np.uint8
