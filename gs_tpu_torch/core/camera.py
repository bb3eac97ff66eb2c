"""Camera math — port of ``gs_tpu/core/camera.py``.

Matrix conventions mirror the reference implementation exactly
(ref: utils/graphics_utils.py:38-71, scene/cameras.py:63-72):

* ``world_view`` is the world->view matrix ``[[R^T, t],[0,1]]`` applied as
  ``p_view = world_view @ [p, 1]`` (math-normal orientation).
* ``projection_matrix`` is the OpenGL-style matrix with ``z_sign=+1``;
  ``full_proj = proj @ world_view``.
* ``camera_center`` is the inverse-view translation column.
* znear=0.01, zfar=100 (ref: scene/cameras.py:63-64).

The matrices are built in numpy (float64, cast to float32 at the end, as the
JAX package does) and moved to the camera's device once.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

ZNEAR = 0.01
ZFAR = 100.0


def fov2focal(fov: float, pixels: float) -> float:
    # ref: utils/graphics_utils.py:73-74
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    # ref: utils/graphics_utils.py:76-77
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate: np.ndarray = np.zeros(3), scale: float = 1.0) -> np.ndarray:
    """World->view matrix with optional recentering.

    ``R`` is the cam-to-world rotation as stored by the reference loaders,
    ``t`` the world-to-cam translation. ref: utils/graphics_utils.py:38-49.
    """
    Rt = np.zeros((4, 4))
    Rt[:3, :3] = R.transpose()
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    cam_center = C2W[:3, 3]
    cam_center = (cam_center + translate) * scale
    C2W[:3, 3] = cam_center
    Rt = np.linalg.inv(C2W)
    return np.float32(Rt)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection, ref: utils/graphics_utils.py:51-71."""
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)
    top = tan_half_fovy * znear
    bottom = -top
    right = tan_half_fovx * znear
    left = -right
    P = np.zeros((4, 4), dtype=np.float32)
    z_sign = 1.0
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = z_sign
    P[2, 2] = z_sign * zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


@dataclasses.dataclass(frozen=True)
class Camera:
    """One camera: float32 tensors on one device plus plain-int image size.

    Use :func:`make_camera` to construct from COLMAP-style (R, t, FoV).
    """
    world_view: torch.Tensor     # [4,4] p_view = world_view @ [p,1]
    full_proj: torch.Tensor      # [4,4] p_clip = full_proj @ [p,1]
    camera_center: torch.Tensor  # [3]
    tan_fovx: torch.Tensor       # [] float32
    tan_fovy: torch.Tensor       # [] float32
    width: int
    height: int

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tan_fovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tan_fovy)


def make_camera(R: np.ndarray, t: np.ndarray, fovx: float, fovy: float,
                width: int, height: int,
                translate: np.ndarray = np.zeros(3), scale: float = 1.0,
                znear: float = ZNEAR, zfar: float = ZFAR, *,
                device="cuda") -> Camera:
    """Build a Camera with the reference's exact matrix chain.

    ref: scene/cameras.py:69-72 — world_view_transform / projection_matrix /
    full_proj_transform / camera_center (math-normal orientation).
    """
    V = world_to_view(R, t, translate, scale)
    P = projection_matrix(znear, zfar, fovx, fovy)
    full = (P @ V).astype(np.float32)
    cam_center = np.linalg.inv(V)[:3, 3].astype(np.float32)

    def f32(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)

    return Camera(
        world_view=f32(V),
        full_proj=f32(full),
        camera_center=f32(cam_center),
        tan_fovx=f32(math.tan(fovx * 0.5)),
        tan_fovy=f32(math.tan(fovy * 0.5)),
        width=int(width),
        height=int(height),
    )


@dataclasses.dataclass(frozen=True)
class CameraBatch:
    """A stack of cameras sharing (width, height), selected by index — the
    JAX package's traced-index pick of the training camera
    (``gs_tpu/core/camera.py:145-181``): by a plain index (``select``) or
    by a device index (``select_index``, the training step's)."""
    world_view: torch.Tensor      # [B,4,4]
    full_proj: torch.Tensor       # [B,4,4]
    camera_center: torch.Tensor   # [B,3]
    tan_fovx: torch.Tensor        # [B]
    tan_fovy: torch.Tensor        # [B]
    width: int
    height: int

    def __len__(self):
        return self.world_view.shape[0]

    @property
    def device(self) -> torch.device:
        return self.world_view.device

    def select_index(self, index: torch.Tensor) -> Camera:
        """The camera at a device index (``index`` [1] int64 on the
        batch's device), picked by ``index_select``: nothing is read back,
        so a CUDA graph may capture it."""
        def pick(x):
            return x.index_select(0, index)[0]

        return Camera(
            world_view=pick(self.world_view),
            full_proj=pick(self.full_proj),
            camera_center=pick(self.camera_center),
            tan_fovx=pick(self.tan_fovx),
            tan_fovy=pick(self.tan_fovy),
            width=self.width,
            height=self.height,
        )

    def select(self, i) -> Camera:
        return Camera(
            world_view=self.world_view[i],
            full_proj=self.full_proj[i],
            camera_center=self.camera_center[i],
            tan_fovx=self.tan_fovx[i],
            tan_fovy=self.tan_fovy[i],
            width=self.width,
            height=self.height,
        )


def stack_cameras(cams: list) -> CameraBatch:
    if not cams:
        raise ValueError("stack_cameras needs at least one camera")
    w, h = cams[0].width, cams[0].height
    if any((c.width, c.height) != (w, h) for c in cams):
        raise ValueError("a CameraBatch needs one resolution")
    return CameraBatch(
        world_view=torch.stack([c.world_view for c in cams]),
        full_proj=torch.stack([c.full_proj for c in cams]),
        camera_center=torch.stack([c.camera_center for c in cams]),
        tan_fovx=torch.stack([c.tan_fovx for c in cams]),
        tan_fovy=torch.stack([c.tan_fovy for c in cams]),
        width=w, height=h,
    )
