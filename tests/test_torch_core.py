"""gs_tpu_torch core math against gs_tpu on the CPU: camera matrices, SH,
preprocess (every Projected field), the 3-NN scale init and create_from_pcd.

Inputs are made with numpy from a seed and handed to both packages."""
import math

import numpy as np
import pytest
import torch

import gs_tpu.core.camera as jcam
import gs_tpu.core.project as jproj
import gs_tpu.core.sh as jsh
import gs_tpu.core.spatial as jspatial
import gs_tpu.models.gaussian_model as jmodel
from gs_tpu_torch.convert import camera_from_numpy, params_from_numpy
from gs_tpu_torch.core import camera as tcam
from gs_tpu_torch.core import project as tproj
from gs_tpu_torch.core import sh as tsh
from gs_tpu_torch.core import spatial as tspatial
from gs_tpu_torch.models import gaussian_model as tmodel

from utils import default_camera, random_params

CPU = "cpu"


def _rotation(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return q * np.sign(np.linalg.det(q))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("seed", [0, 1])
def test_camera_matrices(seed):
    rng = np.random.default_rng(seed)
    R, t = _rotation(rng), rng.normal(size=3)
    fovx = math.radians(rng.uniform(40, 90))
    fovy = jcam.focal2fov(jcam.fov2focal(fovx, 160), 120)
    translate, scale = rng.normal(size=3), 1.3
    a = jcam.make_camera(R, t, fovx, fovy, 160, 120, translate, scale)
    b = tcam.make_camera(R, t, fovx, fovy, 160, 120, translate, scale, device=CPU)
    for k in ("world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy"):
        np.testing.assert_allclose(_np(getattr(b, k)), np.asarray(getattr(a, k)),
                                   rtol=1e-6, atol=1e-6, err_msg=k)
    assert (b.width, b.height) == (a.width, a.height)
    assert float(b.focal_x) == pytest.approx(float(a.focal_x), rel=1e-6)
    assert tcam.fov2focal(fovx, 160) == jcam.fov2focal(fovx, 160)


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_sh_channels(deg):
    rng = np.random.default_rng(10 + deg)
    n = 257
    coeffs = rng.normal(size=((deg + 1) ** 2, n)).astype(np.float32)
    d = rng.normal(size=(3, n))
    d = (d / np.linalg.norm(d, axis=0)).astype(np.float32)
    a = jsh.eval_sh_channels(deg, list(coeffs), *d)
    b = tsh.eval_sh_channels(deg, list(torch.from_numpy(coeffs)),
                             *torch.from_numpy(d))
    np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-6, atol=1e-6)
    rgb = rng.uniform(size=(5, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(tsh.rgb2sh(torch.from_numpy(rgb))),
                               np.asarray(jsh.rgb2sh(rgb)), rtol=1e-6)


def _jax_params(seed, n=300):
    return random_params(np.random.default_rng(seed), n)


def _arrays(params):
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def _camera_pair(width=128, height=96):
    a = default_camera(width, height)
    b = camera_from_numpy({k: np.asarray(getattr(a, k)) for k in
                           ("world_view", "full_proj", "camera_center",
                            "tan_fovx", "tan_fovy")}, width, height, device=CPU)
    return a, b


@pytest.mark.parametrize("antialiasing", [False, True])
def test_preprocess_matches(antialiasing):
    params = _jax_params(3)
    alive = np.arange(300) < 280
    cam_j, cam_t = _camera_pair()
    pa = jproj.preprocess(params, cam_j, active_sh_degree=3,
                          antialiasing=antialiasing, alive=alive)
    pb = tproj.preprocess(params_from_numpy(_arrays(params), CPU), cam_t,
                          active_sh_degree=3, antialiasing=antialiasing,
                          alive=torch.from_numpy(alive))
    for k in ("radius", "radius_cull", "visible"):
        np.testing.assert_array_equal(_np(getattr(pb, k)),
                                      np.asarray(getattr(pa, k)), err_msg=k)
    vis = np.asarray(pa.visible)
    assert vis.sum() > 100
    for k in ("mean2d", "conic", "depth", "rgb", "opacity"):
        np.testing.assert_allclose(_np(getattr(pb, k))[vis],
                                   np.asarray(getattr(pa, k))[vis],
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_tile_rect_matches():
    rng = np.random.default_rng(4)
    mean2d = rng.uniform(-40, 170, (200, 2)).astype(np.float32)
    rx = rng.integers(0, 30, 200).astype(np.int32)
    ry = rng.integers(0, 30, 200).astype(np.int32)
    a = jproj.tile_rect(mean2d, rx, 8, 6, 16, 16, radius_y=ry)
    b = tproj.tile_rect(torch.from_numpy(mean2d), torch.from_numpy(rx), 8, 6,
                        16, 16, radius_y=torch.from_numpy(ry))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(_np(y), np.asarray(x))


def test_mean_sq_dist_to_3nn():
    rng = np.random.default_rng(6)
    pts = rng.uniform(-2, 2, (600, 3)).astype(np.float32)
    a = jspatial.mean_sq_dist_to_3nn(pts)
    b = tspatial.mean_sq_dist_to_3nn(torch.from_numpy(pts))
    np.testing.assert_allclose(_np(b), np.asarray(a), rtol=1e-5)


def test_create_from_pcd():
    rng = np.random.default_rng(7)
    pts = rng.uniform(-3, 3, (500, 3))
    cols = rng.uniform(0, 1, (500, 3))
    pa, alive_a = jmodel.create_from_pcd(pts, cols, sh_degree=3, capacity=1024)
    pb, alive_b = tmodel.create_from_pcd(pts, cols, sh_degree=3, capacity=1024,
                                         device=CPU)
    np.testing.assert_array_equal(_np(alive_b), np.asarray(alive_a))
    for k in pa._fields:
        np.testing.assert_allclose(_np(getattr(pb, k)), np.asarray(getattr(pa, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
