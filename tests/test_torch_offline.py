"""The port's offline tools against the JAX package's on the CPU: the COLMAP
converter with a stub ``colmap`` (tests/test_convert_fulleval.py), full_eval
end to end on two tiny scenes, make_depth_scale's depth_params.json, the
camera-frustum plot, and checkpoints the JAX package wrote (read bitwise,
chunked arrays included; resumed by the port's train CLI)."""
import json
import os
import shutil
import stat
import sys

import numpy as np
import pytest
import torch

from gs_tpu_torch.apps import convert as convert_app
from gs_tpu_torch.apps import full_eval
from gs_tpu_torch.apps import make_depth_scale
from gs_tpu_torch.apps import train as train_app
from gs_tpu_torch.apps import visualize_cameras
from gs_tpu_torch.convert import state_to_numpy
from gs_tpu_torch.data import colmap
from gs_tpu_torch.data.scene import Scene
from gs_tpu_torch.train.checkpoint import load_checkpoint

from test_convert_fulleval import STUB_COLMAP
from test_data import make_colmap_dataset
from test_depth import write_depth_png


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Train as on a machine without tensorboard (its import takes ~10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_convert_cli_with_stub_colmap(tmp_path, rng, monkeypatch):
    """tests/test_convert_fulleval.py::test_convert_cli_with_stub_colmap."""
    staging = tmp_path / "staging"
    make_colmap_dataset(str(staging), rng, n_images=6, width=64, height=48)
    src = tmp_path / "scene"
    os.makedirs(src / "input")
    for f in os.listdir(staging / "images"):
        os.link(staging / "images" / f, src / "input" / f)
    stub = tmp_path / "bin" / "colmap"
    os.makedirs(stub.parent)
    stub.write_text(STUB_COLMAP)
    stub.chmod(stub.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "colmap_calls.log"
    monkeypatch.setenv("STUB_LOG", str(log))
    monkeypatch.setenv("STUB_SPARSE", str(staging / "sparse" / "0"))
    monkeypatch.setenv("PATH", f"{stub.parent}:{os.environ.get('PATH', '')}")

    convert_app.main(["-s", str(src), "--no_gpu", "--resize"])

    calls = [l.split()[0] for l in log.read_text().strip().splitlines()]
    assert calls == ["feature_extractor", "exhaustive_matcher", "mapper",
                     "image_undistorter"]
    full = log.read_text()
    assert "--ImageReader.camera_model OPENCV" in full
    assert "--Mapper.ba_global_function_tolerance=0.000001" in full
    assert "--SiftExtraction.use_gpu 0" in full
    assert {"cameras.bin", "images.bin", "points3D.bin"} <= set(
        os.listdir(src / "sparse" / "0"))
    from PIL import Image
    for scale, sub in ((2, "images_2"), (4, "images_4"), (8, "images_8")):
        files = os.listdir(src / sub)
        assert len(files) == 6
        with Image.open(src / sub / files[0]) as im:
            assert im.width == 64 // scale
    scene = Scene(str(src), str(tmp_path / "model"), eval_split=False,
                  device="cpu")
    assert len(scene.get_train_cameras()) == 6


def test_full_eval_end_to_end(tmp_path, rng, capsys):
    """tests/test_convert_fulleval.py::test_full_eval_end_to_end on the
    port's apps: train -> render -> metrics in process, on the CPU."""
    tat = tmp_path / "tandt"
    for name in ("truck", "train"):
        make_colmap_dataset(str(tat / name), rng, n_images=8, width=64,
                            height=48)
    out = tmp_path / "eval"
    full_eval.main([
        "-tat", str(tat), "--output_path", str(out), "--iterations", "6",
        "--data_device", "cpu",
        "--densify_from_iter", "3", "--densification_interval", "4",
        "--opacity_reset_interval", "1000",
        "--dup_capacity", "4096", "--max_per_tile", "64", "--chunk", "32",
    ])
    text = capsys.readouterr().out
    for stage in ("training", "rendering", "metrics"):
        assert f"{stage} total:" in text
    for name in ("truck", "train"):
        model = out / name
        with open(model / "config.json") as f:
            assert json.load(f)["model"]["data_device"] == "cpu"
        assert (model / "cfg_args").exists()
        assert (model / "point_cloud" / "iteration_6"
                / "point_cloud.ply").exists()
        renders = model / "test" / "ours_6" / "renders"
        assert len(os.listdir(renders)) == 1       # llffhold=8 on 8 images
        with open(model / "results.json") as f:
            res = json.load(f)["ours_6"]
        assert 0 <= res["SSIM"] <= 1 and res["PSNR"] > 5


def test_make_depth_scale_matches_jax(tmp_path, rng):
    """The port's CLI writes the depth_params.json the JAX CLI writes on the
    same dataset (tests/test_depth.py's synthetic depth maps); both fit in
    numpy float64."""
    from gs_tpu.apps import make_depth_scale as jax_make_depth_scale
    root = tmp_path / "scene"
    make_colmap_dataset(str(root), rng, n_images=6, width=64, height=48)
    sparse = root / "sparse" / "0"
    os.makedirs(root / "depths")
    images = colmap.read_extrinsics_binary(str(sparse / "images.bin"))
    cams = colmap.read_intrinsics_binary(str(sparse / "cameras.bin"))
    for k, im in enumerate(images.values()):
        intr = cams[im.camera_id]
        yy, xx = np.mgrid[0:intr.height, 0:intr.width]
        ray_z = np.linalg.norm(im.tvec) + 0.3 * (xx / intr.width - 0.5)
        inv = 0.45 * (1.0 / np.maximum(ray_z, 0.5)) + 0.08
        inv = inv + 0.01 * np.sin(0.3 * yy + k)
        base = os.path.splitext(os.path.basename(im.name))[0]
        write_depth_png(str(root / "depths" / (base + ".png")), inv)
    other = tmp_path / "scene_jax"
    shutil.copytree(root, other)

    make_depth_scale.main(["-s", str(root), "-d", "depths",
                           "--min_points", "5"])
    jax_make_depth_scale.main(["-s", str(other), "-d", "depths",
                               "--min_points", "5"])
    with open(sparse / "depth_params.json") as f:
        got = json.load(f)
    with open(other / "sparse" / "0" / "depth_params.json") as f:
        ref = json.load(f)
    assert set(got) == set(ref) and len(got) == 6
    assert any(v["scale"] != 0 for v in got.values())
    for name, v in ref.items():
        for k in ("scale", "offset"):
            assert got[name][k] == pytest.approx(v[k], rel=1e-12, abs=1e-12)


def test_visualize_cameras(tmp_path, rng):
    from gs_tpu.apps.visualize_cameras import frustum_lines as jax_frustum
    root = tmp_path / "scene"
    make_colmap_dataset(str(root), rng, n_images=5, width=64, height=48)
    images = colmap.read_extrinsics_binary(
        str(root / "sparse" / "0" / "images.bin"))
    for im in images.values():
        R = colmap.qvec2rotmat(im.qvec)
        for got, want in zip(visualize_cameras.frustum_lines(R, im.tvec, 0.4),
                             jax_frustum(R, im.tvec, 0.4)):
            np.testing.assert_array_equal(got, want)
    out = tmp_path / "cams.png"
    visualize_cameras.main(["-s", str(root), "-o", str(out)])
    from PIL import Image
    with Image.open(out) as im:
        assert im.width > 100 and im.height > 100


def _jax_state(rng, capacity, num_images, sh_degree=1, n=40):
    """A gs_tpu TrainState with every leaf non-trivial (moments, statistics,
    exposure, step counters)."""
    import jax.numpy as jnp
    from gs_tpu.models.gaussian_model import create_from_pcd, init_state
    pts = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                          rng.uniform(2, 4, (n, 1))], 1)
    params, alive = create_from_pcd(pts, rng.uniform(0, 1, (n, 3)),
                                    sh_degree, capacity=capacity)
    s = init_state(params, alive, num_images)

    def noisy(p):
        return type(p)(*[jnp.asarray(rng.normal(size=x.shape), jnp.float32)
                         for x in p])

    c = capacity
    return s._replace(
        m=noisy(s.m), v=type(s.v)(*[jnp.abs(x) for x in noisy(s.v)]),
        step=jnp.int32(17),
        grad_accum=jnp.asarray(rng.uniform(0, 1, c), jnp.float32),
        denom=jnp.asarray(rng.integers(0, 9, c), jnp.float32),
        max_radii2D=jnp.asarray(rng.integers(0, 30, c), jnp.int32),
        exposure=s.exposure + jnp.asarray(
            rng.normal(0, 1e-3, s.exposure.shape), jnp.float32),
        exp_step=jnp.int32(5))


@pytest.mark.parametrize("chunked", [False, True])
def test_read_jax_checkpoint_bitwise(tmp_path, rng, monkeypatch, chunked):
    """A gs_tpu save_checkpoint blob reads back leaf by leaf, bitwise; with
    flax's MAX_CHUNK_SIZE at 4 KB the large leaves are chunked arrays."""
    from flax import serialization
    from gs_tpu.train.checkpoint import save_checkpoint as jax_save
    state = _jax_state(rng, capacity=128, num_images=3, sh_degree=2)
    if chunked:
        monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 4096)
    path = str(tmp_path / "chkpnt9.pth")
    jax_save(path, state, 9, 2.5)
    with open(path, "rb") as f:
        blob = f.read()
    # sh_rest [128, 8, 3] float32 is 12,288 bytes: three chunks of 4 KB
    assert (b"__msgpack_chunked_array__" in blob) == chunked

    got, it, slrs = load_checkpoint(path, device="cpu")
    assert (it, slrs) == (9, 2.5)
    arrays = state_to_numpy(got)
    for k, v in state._asdict().items():
        pairs = ([(f"{k}.{f}", np.asarray(x), arrays[k][f])
                  for f, x in v._asdict().items()] if isinstance(v, tuple)
                 else [(k, np.asarray(v), arrays[k])])
        for name, want, have in pairs:
            assert have.dtype == want.dtype, name
            assert have.shape == want.shape, name
            assert have.tobytes() == want.tobytes(), name


def test_resume_from_jax_checkpoint(tmp_path, rng):
    """The port's train CLI resumes from a chkpnt*.pth the JAX package
    wrote, by --start_checkpoint and by --resume."""
    from gs_tpu.train.checkpoint import save_checkpoint as jax_save
    root = str(tmp_path / "dataset")
    make_colmap_dataset(root, np.random.default_rng(3), n_images=8,
                        width=64, height=48)
    # the CLI's defaults: SH degree 3; 7 train views with --eval
    state = _jax_state(rng, capacity=1024, num_images=7, sh_degree=3)
    model = tmp_path / "model"
    ckpt = str(model / "chkpnt4.pth")
    jax_save(ckpt, state, 4, 3.0)
    args = ["-s", root, "-m", str(model), "--test_iterations", "7",
            "--densify_from_iter", "100", "--opacity_reset_interval", "1000",
            "--dup_capacity", "4096", "--max_per_tile", "64", "--chunk", "32",
            "--disable_viewer", "--quiet", "--eval", "--data_device", "cpu"]
    tr = train_app.main(args + ["--iterations", "6", "--save_iterations", "6",
                                "--start_checkpoint", ckpt])
    assert tr.iteration == 6 and int(tr.state.step) == 19
    assert tr.state.capacity == 1024
    assert os.path.exists(model / "point_cloud" / "iteration_6"
                          / "point_cloud.ply")
    tr = train_app.main(args + ["--iterations", "7", "--save_iterations", "7",
                                "--resume"])
    assert tr.iteration == 7 and int(tr.state.step) == 20
