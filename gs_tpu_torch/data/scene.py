"""Scene container: cameras + point cloud + model-dir layout — port of
``gs_tpu/data/scene.py`` (ref: scene/__init__.py:28-137).

Loads a COLMAP/Blender dataset, computes the NeRF++ camera extent, shuffles
the training cameras, dumps ``cameras.json`` and ``input.ply`` into the model
dir, and saves/loads Gaussian PLY snapshots at
``point_cloud/iteration_N/point_cloud.ply``. The cameras live on ``device``
(``cuda`` by default); the images stay host numpy arrays.
"""
from __future__ import annotations

import json
import os
import random
import shutil
from typing import Optional

import numpy as np
import torch

from .camera_utils import LoadedCamera, camera_to_json, load_camera
from .dataset_readers import SceneInfo, load_scene_info
from .ply import load_gaussian_ply, save_gaussian_ply, search_max_iteration


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class Scene:
    """Holds train/test cameras per resolution scale and the init point cloud.

    Unlike the reference, the Gaussian model state lives outside the Scene (it
    is owned by the training loop); Scene only handles data and the on-disk
    model layout.
    """

    def __init__(self, source_path: str, model_path: str, *,
                 images: str = "images", depths: str = "",
                 resolution: int = -1, white_background: bool = False,
                 eval_split: bool = False, train_test_exp: bool = False,
                 shuffle: bool = True, resolution_scales=(1.0,),
                 scene_info: Optional[SceneInfo] = None, llffhold: int = 8,
                 device="cuda"):
        self.model_path = model_path
        self.train_test_exp = train_test_exp

        if scene_info is None:
            scene_info = load_scene_info(source_path, images, depths,
                                         eval_split, llffhold)
        self.scene_info = scene_info
        self.cameras_extent = float(scene_info.nerf_normalization["radius"])
        self.point_cloud = scene_info.point_cloud

        if model_path:
            os.makedirs(model_path, exist_ok=True)
            # input.ply copy + cameras.json (ref: scene/__init__.py:63-82)
            try:
                shutil.copyfile(scene_info.ply_path,
                                os.path.join(model_path, "input.ply"))
            except (FileNotFoundError, shutil.SameFileError):
                pass
            cam_json = []
            for i, cam in enumerate(scene_info.test_cameras +
                                    scene_info.train_cameras):
                cam_json.append(camera_to_json(i, cam))
            with open(os.path.join(model_path, "cameras.json"), "w") as f:
                json.dump(cam_json, f)

        train_infos = list(scene_info.train_cameras)
        test_infos = list(scene_info.test_cameras)
        if shuffle:
            random.shuffle(train_infos)   # ref: scene/__init__.py:84-86

        self.train_cameras: dict[float, list[LoadedCamera]] = {}
        self.test_cameras: dict[float, list[LoadedCamera]] = {}
        for scale in resolution_scales:
            print(f"Loading Training Cameras at scale {scale}")
            self.train_cameras[scale] = [
                load_camera(info, resolution, scale, white_background,
                            scene_info.is_nerf_synthetic, train_test_exp,
                            is_test_dataset=False, device=device)
                for info in train_infos]
            print(f"Loading Test Cameras at scale {scale}")
            self.test_cameras[scale] = [
                load_camera(info, resolution, scale, white_background,
                            scene_info.is_nerf_synthetic, train_test_exp,
                            is_test_dataset=True, device=device)
                for info in test_infos]

    def get_train_cameras(self, scale: float = 1.0) -> list[LoadedCamera]:
        return self.train_cameras[scale]

    def get_test_cameras(self, scale: float = 1.0) -> list[LoadedCamera]:
        return self.test_cameras[scale]

    # ------------------------------------------------------- model snapshots

    def save(self, iteration: int, params, alive,
             exposure=None):
        """PLY snapshot of the alive Gaussians
        (ref: scene/__init__.py:104-106 + gaussian_model.py:193-224).
        ``params`` is a GaussianParams of tensors or arrays."""
        out_dir = os.path.join(self.model_path, "point_cloud",
                               f"iteration_{iteration}")
        os.makedirs(out_dir, exist_ok=True)
        mask = _host(alive)
        save_gaussian_ply(
            os.path.join(out_dir, "point_cloud.ply"),
            xyz=_host(params.xyz)[mask],
            sh_dc=_host(params.sh_dc)[mask],
            sh_rest=_host(params.sh_rest)[mask],
            logit_opacity=_host(params.logit_opacity)[mask],
            log_scale=_host(params.log_scale)[mask],
            quat=_host(params.quat)[mask])
        if exposure is not None:
            # upstream saves exposure.json mapping image name -> 3x4 matrix.
            # The trainer indexes state.exposure by position in the LOADED
            # (shuffled) train-camera list, so the mapping must be built from
            # that same order — not from the unshuffled scene_info order.
            scale = (1.0 if 1.0 in self.train_cameras
                     else next(iter(self.train_cameras)))
            names = [c.info.image_name
                     for c in (self.train_cameras[scale] +
                               self.test_cameras.get(scale, []))]
            exp = _host(exposure)
            mapping = {n: exp[min(i, len(exp) - 1)].tolist()
                       for i, n in enumerate(names)}
            with open(os.path.join(self.model_path, "exposure.json"), "w") as f:
                json.dump(mapping, f, indent=2)

    def load_ply(self, iteration: int = -1):
        """Load a saved snapshot; -1 picks the latest
        (ref: scene/__init__.py:40-47 + gaussian_model.py:231-272)."""
        pc_dir = os.path.join(self.model_path, "point_cloud")
        if iteration == -1:
            iteration = search_max_iteration(pc_dir)
        path = os.path.join(pc_dir, f"iteration_{iteration}",
                            "point_cloud.ply")
        return load_gaussian_ply(path), iteration
