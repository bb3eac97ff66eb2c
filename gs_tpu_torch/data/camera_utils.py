"""Camera/image loading: resolution policy, alpha masks, depth priors,
cameras.json serialization — port of ``gs_tpu/data/camera_utils.py``. The
camera is the port's ``Camera`` on the device the caller names (``cuda`` by
default); images, masks and depth maps stay host numpy arrays, as in the JAX
package, and the trainer moves them.

Behavioral port of the reference camera pipeline with the upstream-intended
depth/alpha semantics (ref: utils/camera_utils.py:15-102, scene/cameras.py:18-72;
the snapshot's merge breakages in these files are listed in SURVEY.md §0.1):

* resolution policy: explicit 1/2/4/8 downscale, or auto-halve anything wider
  than 1600 px when ``resolution == -1`` (ref: utils/camera_utils.py:42-59)
* RGBA images keep an alpha mask; on Blender data RGB is composited onto the
  chosen background (ref: scene/dataset_readers.py:222-228)
* ``train_test_exp`` zeros half of the alpha mask on eval-side views so the
  exposure-compensated halves are scored separately (upstream cameras.py)
* inverse-depth priors: 16-bit PNGs scaled by depth_params {scale, offset},
  reliability-gated on scale vs 5x/0.2x med_scale (upstream cameras.py:45-61)
* cameras.json entries (ref: utils/camera_utils.py:82-102 camera_to_JSON)
"""
from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional

import numpy as np

from ..core.camera import Camera, fov2focal, make_camera
from .dataset_readers import CameraInfo

WARNED = [False]


class LoadedCamera(NamedTuple):
    """A Camera plus its host-side training data (numpy, CHW in [0,1])."""
    camera: Camera
    info: CameraInfo
    image: np.ndarray                 # [3, H, W] float32
    alpha_mask: np.ndarray            # [1, H, W] float32
    invdepth: Optional[np.ndarray]    # [H, W] float32 or None
    depth_mask: Optional[np.ndarray]  # [H, W] float32 or None
    depth_reliable: bool


def resolve_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """ref: utils/camera_utils.py:42-59 (loadCam resolution policy)."""
    if resolution in (1, 2, 4, 8):
        scale = resolution_scale * resolution
        return round(orig_w / scale), round(orig_h / scale)
    if resolution == -1:
        if orig_w > 1600:
            if not WARNED[0]:
                print("[ INFO ] Encountered quite large input images "
                      "(>1.6K pixels width), rescaling to 1.6K.\n If this is "
                      "not desired, please explicitly specify '--resolution/-r'"
                      " as 1")
                WARNED[0] = True
            global_down = orig_w / 1600
        else:
            global_down = 1
        scale = float(global_down) * resolution_scale
    else:
        # explicit target width (ref: :57-59)
        scale = orig_w / resolution * resolution_scale
    return int(orig_w / scale), int(orig_h / scale)


def load_image_rgba(path: str, size: tuple[int, int]) -> np.ndarray:
    """[C, H, W] float32 in [0,1]; C=3 or 4 (PIL load + bicubic-equivalent
    LANCZOS resize, matching PILtoTorch ref: utils/general_utils.py:21-27)."""
    from PIL import Image
    with Image.open(path) as im:
        if im.size != size:
            im = im.resize(size)
        arr = np.asarray(im, dtype=np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[:, :, None].repeat(3, axis=2)
    return arr.transpose(2, 0, 1)


def load_invdepth(path: str, size: tuple[int, int]):
    """16-bit inverse-depth PNG -> [H, W] float32 (upstream make_depth_scale
    convention; consumed at cameras.py:45-57)."""
    import cv2
    raw = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if raw is None:
        raise FileNotFoundError(path)
    inv = raw.astype(np.float32)
    if raw.dtype == np.uint16:
        inv = inv / (2 ** 16 - 1)
    if inv.ndim == 3:
        inv = inv[..., 0]
    if (inv.shape[1], inv.shape[0]) != size:
        inv = cv2.resize(inv, size)
    return inv


def load_camera(info: CameraInfo, resolution: int = -1,
                resolution_scale: float = 1.0,
                white_background: bool = False,
                is_nerf_synthetic: bool = False,
                train_test_exp: bool = False,
                is_test_dataset: bool = False,
                translate: np.ndarray = np.zeros(3),
                scene_scale: float = 1.0, *, device="cuda") -> LoadedCamera:
    """Load one view: image + masks + depth + Camera struct on ``device``
    (ref: utils/camera_utils.py:15-80 loadCam / cameraList_from_camInfos)."""
    w, h = resolve_resolution(info.width, info.height, resolution,
                              resolution_scale)
    rgba = load_image_rgba(info.image_path, (w, h))
    if rgba.shape[0] == 4:
        alpha = rgba[3:4]
        if is_nerf_synthetic:
            # composite onto the background (ref: scene/dataset_readers.py:222-228)
            bg = 1.0 if white_background else 0.0
            image = rgba[:3] * alpha + bg * (1.0 - alpha)
        else:
            image = rgba[:3]
    else:
        alpha = np.ones((1, h, w), np.float32)
        image = rgba[:3]
    image = np.clip(image, 0.0, 1.0).astype(np.float32)

    # train_test_exp half-image masking (upstream cameras.py)
    if train_test_exp and info.is_test:
        alpha = alpha.copy()
        if is_test_dataset:
            alpha[..., :alpha.shape[-1] // 2] = 0.0
        else:
            alpha[..., alpha.shape[-1] // 2:] = 0.0

    invdepth = None
    depth_mask = None
    depth_reliable = False
    if info.depth_path and os.path.exists(info.depth_path):
        invdepth = load_invdepth(info.depth_path, (w, h))
        invdepth[invdepth < 0] = 0.0
        depth_mask = np.ones((h, w), np.float32)
        depth_reliable = True
        dp = info.depth_params
        if dp is not None:
            if dp["scale"] < 0.2 * dp["med_scale"] or \
                    dp["scale"] > 5.0 * dp["med_scale"]:
                depth_reliable = False
                depth_mask *= 0.0
            if dp["scale"] > 0:
                invdepth = invdepth * dp["scale"] + dp["offset"]

    cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h,
                      translate=translate, scale=scene_scale, device=device)
    return LoadedCamera(camera=cam, info=info, image=image, alpha_mask=alpha,
                        invdepth=invdepth, depth_mask=depth_mask,
                        depth_reliable=depth_reliable)


def camera_to_json(idx: int, info: CameraInfo) -> dict:
    """ref: utils/camera_utils.py:82-102 (camera_to_JSON)."""
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = info.R.transpose()
    Rt[:3, 3] = info.T
    Rt[3, 3] = 1.0
    W2C = np.linalg.inv(Rt)
    pos = W2C[:3, 3]
    rot = W2C[:3, :3]
    return {
        "id": idx,
        "img_name": info.image_name,
        "width": info.width,
        "height": info.height,
        "position": pos.tolist(),
        "rotation": [r.tolist() for r in rot],
        "fy": fov2focal(info.fovy, info.height),
        "fx": fov2focal(info.fovx, info.width),
    }
