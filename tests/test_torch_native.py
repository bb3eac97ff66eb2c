"""The port's native C++ COLMAP parser (gs_tpu_torch/native) against the
port's pure-Python readers and against gs_tpu.native (tests/test_native.py's
cases): the library builds with g++ into gs_tpu_torch/_build/ under a name
keyed by its source, and data/colmap.py's binary readers take it."""
import os

import numpy as np
import pytest

import gs_tpu.native as jax_native

from gs_tpu_torch import native
from gs_tpu_torch.data import colmap

from test_data import make_colmap_dataset


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    rng = np.random.default_rng(11)
    root = str(tmp_path_factory.mktemp("ds"))
    make_colmap_dataset(root, rng, n_images=12)
    return os.path.join(root, "sparse", "0")


@pytest.fixture
def python_route(monkeypatch):
    """Force data/colmap.py's per-record Python loops."""
    monkeypatch.setattr(native, "available", lambda: False)


def test_native_builds():
    assert native.available(), "native library failed to build"
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD
    assert path.name.startswith("colmap_io-")
    assert native.SOURCE.is_file()


def test_points3d_matches_python_and_jax(dataset, monkeypatch):
    path = os.path.join(dataset, "points3D.bin")
    before = native.reads
    got = colmap.read_points3D_binary(path)          # native route
    assert native.reads == before + 1
    monkeypatch.setattr(native, "available", lambda: False)
    py = colmap.read_points3D_binary(path)
    assert native.reads == before + 1
    want = jax_native.read_points3d_bin(path)
    for g, p, w in zip(got, py, want):
        assert g.dtype == p.dtype == w.dtype and g.shape == p.shape
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, w)


def test_images_cameras_match_python_and_jax(dataset, monkeypatch):
    ipath = os.path.join(dataset, "images.bin")
    cpath = os.path.join(dataset, "cameras.bin")
    n_images = colmap.read_extrinsics_binary(ipath)     # native route
    n_cams = colmap.read_intrinsics_binary(cpath)
    j_images = {r["id"]: r for r in jax_native.read_images_bin(ipath)}
    j_cams = {r["id"]: r for r in jax_native.read_cameras_bin(cpath)}
    monkeypatch.setattr(native, "available", lambda: False)
    p_images = colmap.read_extrinsics_binary(ipath)
    p_cams = colmap.read_intrinsics_binary(cpath)
    assert set(n_images) == set(p_images) == set(j_images)
    for k in p_images:
        a, b, j = n_images[k], p_images[k], j_images[k]
        np.testing.assert_array_equal(a.qvec, b.qvec)
        np.testing.assert_array_equal(a.tvec, b.tvec)
        np.testing.assert_array_equal(a.qvec, j["qvec"])
        assert a.name == b.name == j["name"]
        assert a.camera_id == b.camera_id == j["camera_id"]
    assert set(n_cams) == set(p_cams) == set(j_cams)
    for k in p_cams:
        a, b, j = n_cams[k], p_cams[k], j_cams[k]
        assert (a.model, a.width, a.height) == (b.model, b.width, b.height)
        assert (a.width, a.height) == (j["width"], j["height"])
        np.testing.assert_array_equal(a.params, b.params)
        np.testing.assert_array_equal(a.params, j["params"])


def test_empty_and_broken_models(tmp_path):
    """An empty points3D.bin parses to no points; a truncated one raises."""
    empty = str(tmp_path / "empty.bin")
    colmap.write_points3D_binary(np.zeros((0, 3)), np.zeros((0, 3), np.uint8),
                                 None, empty)
    xyz, rgb, err = native.read_points3d_bin(empty)
    assert xyz.shape == (0, 3) and rgb.shape == (0, 3) and err.shape == (0, 1)
    full = str(tmp_path / "full.bin")
    colmap.write_points3D_binary(np.ones((3, 3)), np.ones((3, 3), np.uint8),
                                 np.zeros(3), full)
    with open(full, "rb") as f:
        data = f.read()
    cut = str(tmp_path / "cut.bin")
    with open(cut, "wb") as f:
        f.write(data[:-10])
    with pytest.raises(IOError, match="code 2"):
        native.read_points3d_bin(cut)
    with pytest.raises(FileNotFoundError):
        native.read_points3d_bin(str(tmp_path / "missing.bin"))


def test_python_route_without_the_library(dataset, python_route):
    """With the native route off, the readers still read the model."""
    cams = colmap.read_intrinsics_binary(os.path.join(dataset, "cameras.bin"))
    assert cams and all(c.model in ("PINHOLE", "SIMPLE_PINHOLE")
                        for c in cams.values())
