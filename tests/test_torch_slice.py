"""The serving slice end to end on the CPU: a trained-model directory (PLY
snapshot + cfg_args) rendered by the port's orbit CLI and by gs_tpu's, PNG
for PNG; and the weight carry-over between the packages."""
import os

import numpy as np
import pytest
from PIL import Image

from gs_tpu.apps import view_orbit as jax_orbit
from gs_tpu_torch.apps import view_orbit as torch_orbit
from gs_tpu_torch.config import ModelConfig, asdict
from gs_tpu_torch.convert import params_from_numpy, params_to_numpy
from gs_tpu_torch.data.ply import load_gaussian_ply, save_gaussian_ply

from utils import random_params

FLAGS = ["--data_device", "cpu", "--frames", "2", "--width", "64",
         "--height", "48", "--dup_capacity", "8192", "--max_per_tile", "512"]


def _arrays(seed=21, n=300):
    params = random_params(np.random.default_rng(seed), n)
    return {k: np.asarray(v) for k, v in params._asdict().items()}


def _model_dir(root, arrays):
    """<root>/point_cloud/iteration_7/point_cloud.ply plus a reference-style
    cfg_args, the layout a training run leaves."""
    save_gaussian_ply(os.path.join(root, "point_cloud", "iteration_7",
                                   "point_cloud.ply"),
                      arrays["xyz"], arrays["sh_dc"], arrays["sh_rest"],
                      arrays["logit_opacity"], arrays["log_scale"],
                      arrays["quat"])
    fields = asdict(ModelConfig(model_path=str(root)))
    fields.pop("depths")
    body = ", ".join(f"{k}={v!r}" for k, v in sorted(fields.items()))
    with open(os.path.join(root, "cfg_args"), "w") as f:
        f.write(f"Namespace({body})")
    return str(root)


def test_orbit_cli_matches_jax(tmp_path):
    arrays = _arrays()
    dirs = {}
    for name, cli in (("jax", jax_orbit), ("torch", torch_orbit)):
        root = _model_dir(tmp_path / name, arrays)
        cli.main(["-m", root] + FLAGS)
        dirs[name] = os.path.join(root, "orbit_7")
    frames = sorted(os.listdir(dirs["torch"]))
    assert frames == ["00000.png", "00001.png"] == sorted(os.listdir(dirs["jax"]))
    for f in frames:
        a = np.asarray(Image.open(os.path.join(dirs["jax"], f)), np.int16)
        b = np.asarray(Image.open(os.path.join(dirs["torch"], f)), np.int16)
        assert a.shape == b.shape == (48, 64, 3)
        assert a.std() > 1.0, "orbit frame is blank"
        assert np.abs(a - b).max() <= 1, f


def test_params_round_trip_through_ply_and_numpy(tmp_path):
    arrays = _arrays(seed=22, n=50)
    params = params_from_numpy(arrays, "cpu")
    back = params_to_numpy(params)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v.astype(np.float32), err_msg=k)
    root = _model_dir(tmp_path, back)
    d = load_gaussian_ply(os.path.join(root, "point_cloud", "iteration_7",
                                       "point_cloud.ply"))
    assert d["sh_degree"] == 3
    for k, v in arrays.items():
        np.testing.assert_array_equal(d[k], v, err_msg=k)


def test_orbit_cli_refuses_unknown_device(tmp_path):
    root = _model_dir(tmp_path, _arrays(n=20))
    with pytest.raises(RuntimeError):
        torch_orbit.main(["-m", root, "--data_device", "tpu", "--frames", "1"])


@pytest.mark.parametrize("flag", [
    ["--tile_block", "4"], ["--pallas_expand"], ["--pallas_fold"],
    ["--band_assign", "cost"], ["--visible_capacity", "8"]],
    ids=lambda f: f[0])
def test_orbit_cli_has_no_tpu_only_flags(tmp_path, flag):
    """The JAX package's TPU-kernel and multi-chip knobs select nothing in
    the port, so its CLI refuses them rather than ignore them."""
    root = _model_dir(tmp_path, _arrays(n=20))
    with pytest.raises(SystemExit):
        torch_orbit.main(["-m", root, "--data_device", "cpu", "--frames", "1"]
                         + flag)
    assert not os.path.exists(os.path.join(root, "orbit_7"))
