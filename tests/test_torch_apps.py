"""The port's CLIs on the CPU: train -> render -> metrics on
tests/test_apps.py's tiny COLMAP scene with the JAX package's model-dir
layout, checkpoints (bitwise round trip, resume), the refusals of what is
not ported, the profiler trace and the viewer server's start, and the
stored ``data_device`` of a model directory the JAX package wrote ("tpu",
read as "cuda")."""
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from gs_tpu import config as jax_config
from gs_tpu.data.ply import save_gaussian_ply as jax_save_gaussian_ply

from gs_tpu_torch.apps import metrics as metrics_app
from gs_tpu_torch.apps import render as render_app
from gs_tpu_torch.apps import train as train_app
from gs_tpu_torch.apps import view_orbit
from gs_tpu_torch.apps.args import (get_combined_args, make_parser,
                                    resolve_data_device)
from gs_tpu_torch.convert import state_to_numpy
from gs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

from test_data import make_colmap_dataset


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's thread pool gives nothing, and beside
    other test processes its threads oversubscribe the cores (a parallel
    region then waits on threads that are not running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    """Train as on a machine without tensorboard (its import takes ~10 s)."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def tiny_scene(tmp_path_factory):
    rng = np.random.default_rng(3)
    root = str(tmp_path_factory.mktemp("dataset"))
    make_colmap_dataset(root, rng, n_images=8, width=64, height=48)
    return root


def _train_args(root, model, iters=12, extra=()):
    """tests/test_apps.py's flags, on the CPU."""
    return ["-s", root, "-m", model,
            "--iterations", str(iters),
            "--test_iterations", str(iters),
            "--save_iterations", str(iters),
            "--densify_from_iter", "4",
            "--densification_interval", "5",
            "--opacity_reset_interval", "1000",
            "--dup_capacity", "4096", "--max_per_tile", "64",
            "--chunk", "32", "--disable_viewer", "--quiet",
            "--eval", "--data_device", "cpu", *extra]


def test_train_render_metrics_cli(tiny_scene, tmp_path, capsys):
    model = str(tmp_path / "model")
    trainer = train_app.main(_train_args(
        tiny_scene, model, extra=["--checkpoint_iterations", "12"]))
    assert trainer.iteration == 12 and trainer.ema_loss > 0
    assert trainer.state.alive.device == torch.device("cpu")

    # the JAX package's model-dir layout (tests/test_apps.py)
    for rel in ("cfg_args", "config.json", "cameras.json", "input.ply",
                "point_cloud/iteration_12/point_cloud.ply", "chkpnt12.pth"):
        assert os.path.exists(os.path.join(model, rel)), rel
    with open(os.path.join(model, "config.json")) as f:
        cfg = json.load(f)
    for section, cls in (("model", jax_config.ModelConfig),
                         ("pipeline", jax_config.PipelineConfig),
                         ("optimization", jax_config.OptimizationConfig)):
        assert set(cfg[section]) == {f.name for f in dataclasses.fields(cls)}
    assert cfg["model"]["data_device"] == "cpu"
    assert "Evaluating test" in capsys.readouterr().out

    render_app.main(["-m", model, "--quiet", "--dup_capacity", "4096",
                     "--max_per_tile", "64", "--chunk", "32"])
    renders = os.path.join(model, "test", "ours_12", "renders")
    gts = os.path.join(model, "test", "ours_12", "gt")
    assert len(os.listdir(renders)) == 1   # 8 images, llffhold 8: 1 test view
    assert sorted(os.listdir(renders)) == sorted(os.listdir(gts))
    assert len(os.listdir(os.path.join(model, "train", "ours_12",
                                       "renders"))) == 7

    metrics_app.main(["-m", model, "--data_device", "cpu"])
    assert "LPIPS unavailable" in capsys.readouterr().out
    with open(os.path.join(model, "results.json")) as f:
        entry = json.load(f)["ours_12"]
    assert 0 <= entry["SSIM"] <= 1 and entry["PSNR"] > 5
    with open(os.path.join(model, "per_view.json")) as f:
        assert set(json.load(f)["ours_12"]) == {"SSIM", "PSNR"}


def test_checkpoint_round_trip_and_resume(tiny_scene, tmp_path):
    model = str(tmp_path / "model")
    train_app.main(_train_args(tiny_scene, model, iters=6,
                               extra=["--checkpoint_iterations", "6"]))
    state, it, slrs = load_checkpoint(os.path.join(model, "chkpnt6.pth"),
                                      device="cpu")
    assert it == 6 and int(state.step) == 6 and slrs > 0

    path = str(tmp_path / "x.pth")
    save_checkpoint(path, state, 6, slrs)
    again, it2, slrs2 = load_checkpoint(path, device="cpu")
    assert (it2, slrs2) == (6, slrs)
    a, b = state_to_numpy(state), state_to_numpy(again)
    for k, v in a.items():
        for f, x in (v.items() if isinstance(v, dict) else [(k, v)]):
            y = b[k][f] if isinstance(v, dict) else b[k]
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes(), (k, f)

    model2 = str(tmp_path / "model2")
    trainer = train_app.main(_train_args(tiny_scene, model2, iters=8) +
                             ["--start_checkpoint",
                              os.path.join(model, "chkpnt6.pth")])
    assert trainer.iteration == 8 and int(trainer.state.step) == 8
    assert os.path.exists(os.path.join(
        model2, "point_cloud", "iteration_8", "point_cloud.ply"))

    # --resume picks the newest checkpoint of the model dir
    trainer = train_app.main(_train_args(tiny_scene, model, iters=7) +
                             ["--resume"])
    assert trainer.iteration == 7 and int(trainer.state.step) == 7


@pytest.mark.parametrize("mesh", ["2", "8"])
def test_mesh_needs_as_many_cards(tiny_scene, tmp_path, mesh):
    """--mesh N on a machine with fewer CUDA devices than N (here the CPU,
    which has none) raises before anything trains; nothing falls back to
    one device."""
    model = tmp_path / "m"
    with pytest.raises(RuntimeError, match=f"--mesh {mesh} needs {mesh} "
                                           "CUDA devices"):
        train_app.main(_train_args(tiny_scene, str(model))
                       + ["--mesh", mesh])
    assert not model.exists()


def test_multihost_needs_its_environment(tiny_scene, tmp_path, monkeypatch):
    """--multihost forms its group from GS_TPU_COORD/GS_TPU_NPROCS/
    GS_TPU_PROCID or a launcher's variables, and raises without them."""
    for var in ("GS_TPU_COORD", "GS_TPU_NPROCS", "GS_TPU_PROCID",
                "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="--multihost needs its environment"):
        train_app.main(_train_args(tiny_scene, str(tmp_path / "m"))
                       + ["--multihost"])
    monkeypatch.setenv("GS_TPU_COORD", "127.0.0.1:1")
    with pytest.raises(ValueError, match="GS_TPU_NPROCS"):
        train_app.main(_train_args(tiny_scene, str(tmp_path / "m"))
                       + ["--multihost"])


@pytest.mark.parametrize("mesh", ["1", "auto"])
def test_mesh_one_is_the_single_device_path(tiny_scene, tmp_path, mesh):
    """--mesh 1, and --mesh auto where there is at most one card (the CPU
    here), train on one device with no group."""
    model = str(tmp_path / "model")
    trainer = train_app.main(_train_args(tiny_scene, model, iters=6)
                             + ["--mesh", mesh])
    assert trainer.mesh is None and trainer.iteration == 6
    assert os.path.exists(os.path.join(model, "point_cloud", "iteration_6",
                                       "point_cloud.ply"))


def test_profile_trace_and_viewer_notice(tiny_scene, tmp_path, capsys):
    """Without --disable_viewer the viewer server starts on the given port
    (a free one here) and is closed at the end; a port already taken is
    reported and training goes on."""
    import socket
    model = str(tmp_path / "model")
    trace = str(tmp_path / "trace")
    args = [a for a in _train_args(tiny_scene, model, iters=6)
            if a != "--disable_viewer"]
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    train_app.main(args + ["--profile", trace, "--profile_steps", "2",
                           "--port", str(port)])
    path = os.path.join(trace, "trace.json")
    assert os.path.getsize(path) > 0
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    out = capsys.readouterr().out
    assert f"GUI server started at 127.0.0.1:{port}" in out
    assert "Viewer server unavailable" not in out
    with socket.socket() as s:   # closed at the end of training
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("127.0.0.1", port))
        s.listen()
        tr = train_app.main(args + ["--port", str(port), "--iterations", "2",
                                    "--test_iterations", "2"])
    assert tr.iteration == 2
    assert "Viewer server unavailable" in capsys.readouterr().out


# ---------------------------------------------------------- data_device

def test_resolve_data_device():
    assert resolve_data_device("tpu") == torch.device("cuda")
    assert resolve_data_device("cpu") == torch.device("cpu")
    assert resolve_data_device("cuda") == torch.device("cuda")
    with pytest.raises(RuntimeError):
        resolve_data_device("gpu0")


def _jax_model_dir(root, rng):
    """A model dir as gs_tpu writes it: its default ModelConfig (so
    data_device "tpu") and a 40-Gaussian snapshot."""
    model = str(root / "jax_model")
    jax_config.save_config(model, jax_config.ModelConfig(model_path=model),
                           jax_config.PipelineConfig(),
                           jax_config.OptimizationConfig())
    n = 40
    xyz = np.concatenate([rng.uniform(-1, 1, (n, 2)),
                          rng.uniform(3, 5, (n, 1))], 1).astype(np.float32)
    jax_save_gaussian_ply(
        os.path.join(model, "point_cloud", "iteration_9", "point_cloud.ply"),
        xyz=xyz, sh_dc=rng.uniform(0, 1, (n, 1, 3)).astype(np.float32),
        sh_rest=np.zeros((n, 15, 3), np.float32),
        logit_opacity=np.full((n, 1), 1.0, np.float32),
        log_scale=np.full((n, 3), -2.5, np.float32),
        quat=np.tile(np.float32([1, 0, 0, 0]), (n, 1)))
    return model


def test_stored_tpu_device(tmp_path, rng):
    model = _jax_model_dir(tmp_path, rng)
    with open(os.path.join(model, "config.json")) as f:
        assert json.load(f)["model"]["data_device"] == "tpu"
    parser = make_parser("orbit", include_optimization=False, fill_none=True)
    stored = get_combined_args(parser, ["-m", model])
    assert resolve_data_device(stored.data_device) == torch.device("cuda")
    explicit = get_combined_args(parser, ["-m", model, "--data_device", "cpu"])
    assert resolve_data_device(explicit.data_device) == torch.device("cpu")

    view_orbit.main(["-m", model, "--data_device", "cpu", "--frames", "2",
                     "--width", "64", "--height", "48", "--dup_capacity",
                     "8192", "--max_per_tile", "512"])
    from PIL import Image
    with Image.open(os.path.join(model, "orbit_9", "00001.png")) as im:
        img = np.asarray(im)
    assert img.shape == (48, 64, 3) and img.max() > 0
