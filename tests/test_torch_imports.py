"""gs_tpu_torch stands alone: no file of it, and not chip_smoke.py, imports
jax or gs_tpu; importing it loads no jax; a CPU render launches no kernel;
a missing CUDA compiler raises instead of falling back."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import gs_tpu_torch
from gs_tpu_torch.ops import _cuda
from gs_tpu_torch.ops.expand import expand_rows
from gs_tpu_torch.ops.rasterize import raster_tiles_fwd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(gs_tpu_torch.__file__)
FORBIDDEN = ("jax", "jaxlib", "gs_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_file_imports_jax_or_gs_tpu():
    files = _port_files()
    assert len(files) > 20
    bad = [(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_import_loads_no_jax():
    code = ("import pkgutil, sys, gs_tpu_torch\n"
            "for m in pkgutil.walk_packages(gs_tpu_torch.__path__, 'gs_tpu_torch.'):\n"
            "    __import__(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gs_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


NEW_MODULES = ("gs_tpu_torch.viewer.server", "gs_tpu_torch.viewer.client",
               "gs_tpu_torch.ops.lpips", "gs_tpu_torch.utils.msgpack_reader",
               "gs_tpu_torch.apps.full_eval", "gs_tpu_torch.apps.convert",
               "gs_tpu_torch.apps.convert_lpips",
               "gs_tpu_torch.apps.make_depth_scale",
               "gs_tpu_torch.apps.visualize_cameras")


def test_new_modules_and_checkpoint_reader_load_no_flax():
    """The viewer, LPIPS and offline tools are modules of the package; the
    checkpoint module reads the JAX package's msgpack checkpoints without
    loading flax or msgpack, and no module loads matplotlib or cv2 at
    import."""
    code = ("import sys, importlib\n"
            "import gs_tpu_torch.train.checkpoint\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('flax', 'msgpack', 'jax')]\n"
            "assert not bad, bad\n"
            f"for m in {NEW_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('flax', 'msgpack', 'jax', 'matplotlib', 'cv2')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


LIVE_MODULES = ("gs_tpu_torch.io_live.stream", "gs_tpu_torch.io_live.ingest",
                "gs_tpu_torch.io_live.pointcloud",
                "gs_tpu_torch.io_live.rosbag", "gs_tpu_torch.io_live.fusion",
                "gs_tpu_torch.io_live.gps", "gs_tpu_torch.apps.train_live",
                "gs_tpu_torch.apps.convert_stream",
                "gs_tpu_torch.apps.gps_pub", "gs_tpu_torch.apps.ros_bridge",
                "gs_tpu_torch.utils.msgpack_codec", "gs_tpu_torch.native")


def test_live_modules_load_no_lazy_dependency():
    """The live-capture modules and the native parser import with no
    msgpack (the port carries its own codec), and load PIL, scipy, rospy
    and termios only where they are used; importing the native parser
    builds nothing."""
    code = ("import sys, importlib\n"
            "from gs_tpu_torch import native\n"
            f"for m in {LIVE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('msgpack', 'PIL', 'scipy', 'rospy', 'termios', 'jax', "
            "'gs_tpu', 'cv2')]\n"
            "assert not bad, bad\n"
            "assert not native._state['tried']\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_cpu_render_launches_no_kernel():
    from gs_tpu_torch.core.camera import make_camera
    from gs_tpu_torch.models.gaussian_model import create_from_pcd
    from gs_tpu_torch.render import render
    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-1, 1, (64, 2)),
                          rng.uniform(3, 5, (64, 1))], axis=1)
    params, alive = create_from_pcd(pts, rng.uniform(0, 1, (64, 3)), 3,
                                    device="cpu")
    cam = make_camera(np.eye(3), np.zeros(3), 1.0, 0.8, 48, 32, device="cpu")
    before = (expand_rows.launches, raster_tiles_fwd.launches)
    out = render(cam, params, torch.zeros(3), active_sh_degree=3, alive=alive)
    assert (expand_rows.launches, raster_tiles_fwd.launches) == before
    if not torch.cuda.is_available():
        assert before == (0, 0)
    assert int(out.num_duplicates) > 0 and out.image.abs().sum() > 0


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_cuda, "NVCC_CANDIDATES", ("/nonexistent/nvcc",))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.find_nvcc()


def test_library_names_follow_the_sources():
    paths = [_cuda.library_path(s) for s in _cuda.SOURCES]
    assert len(set(paths)) == len(paths) >= 4
    assert all(p.parent == _cuda.BUILD for p in paths)
    assert all((_cuda.CSRC / s).is_file() for s in _cuda.SOURCES)
