"""Two repairs on the port's side: the Gaussian capacity stays below the
binning's 2^24 limit (its arithmetic, on the CPU without allocating 2^24
rows), and a no-grad render that overflows its buffers renders again at
grown ones (the render CLI and ``Trainer.evaluate``) instead of returning a
truncated image."""
import dataclasses
import os
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from gs_tpu_torch.apps import render as render_app
from gs_tpu_torch.apps import train as train_app
from gs_tpu_torch.models import gaussian_model as gm
from gs_tpu_torch.models.gaussian_model import (MAX_CAPACITY,
                                                default_capacity)
from gs_tpu_torch.ops.binning import F32_EXACT
from gs_tpu_torch.render import MAX_DUP_CAPACITY, overflow_changes
from gs_tpu_torch.train import loop
from gs_tpu_torch.train.loop import Trainer, next_capacity

from test_data import make_colmap_dataset
from test_torch_trainer import port_trainer


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def test_capacity_cap_arithmetic():
    assert MAX_CAPACITY == 16_776_192 == (1 << 24) - 1024
    assert MAX_CAPACITY % 1024 == 0 and MAX_CAPACITY < F32_EXACT
    assert next_capacity(1 << 20) == 1 << 22
    assert next_capacity(1 << 22) == MAX_CAPACITY
    assert next_capacity(MAX_CAPACITY) == MAX_CAPACITY
    assert next_capacity(4096, factor=2) == 8192
    assert default_capacity(10) == 1024
    assert default_capacity(500_000) == 1 << 20
    assert default_capacity(4_194_304) == 1 << 23
    assert default_capacity(4_194_305) == MAX_CAPACITY
    assert default_capacity(MAX_CAPACITY) == MAX_CAPACITY
    with pytest.raises(ValueError, match="larger than the largest capacity"):
        default_capacity(MAX_CAPACITY + 1)
    # create_from_pcd refuses before it allocates anything
    huge = np.broadcast_to(np.zeros(3, np.float32), (MAX_CAPACITY + 1, 3))
    with pytest.raises(ValueError, match="subsample"):
        gm.create_from_pcd(huge, huge, 3, device="cpu")
    params, alive = gm.create_from_pcd(np.ones((3, 3)), np.ones((3, 3)), 0,
                                       device="cpu")
    state = gm.init_state(params, alive, 1)
    with pytest.raises(ValueError, match="MAX_CAPACITY"):
        gm.grow_capacity(state, MAX_CAPACITY + 1024)
    # the duplicate buffer's cap is the binning's, as before
    assert MAX_DUP_CAPACITY == F32_EXACT - 512
    assert overflow_changes(MAX_DUP_CAPACITY, 64, 20_000_000, 10) == {}
    assert overflow_changes(1 << 20, 64, 2_000_000, 100) == {
        "dup_capacity": 2_400_256, "max_per_tile": 128}


@pytest.mark.parametrize("alive,cap,grows,warns", [
    (900, 1024, 4096, False),                      # an ordinary grow
    (3_600_000, 1 << 22, MAX_CAPACITY, False),     # capped at the limit
    (14_300_000, MAX_CAPACITY, None, True),        # past 85 % of the limit
    (800, 1024, None, False),                      # below 85 %: nothing
])
def test_maybe_grow_caps_and_warns(capsys, monkeypatch, alive, cap, grows,
                                   warns):
    """_maybe_grow on a stand-in state (its count and capacity only) of a
    one-device trainer, with grow_capacity recorded instead of run."""
    state = types.SimpleNamespace(num_alive=torch.tensor(alive), capacity=cap)
    tr = types.SimpleNamespace(state=state, capacity_exhausted=0,
                               iteration=700, mesh=None, capacity=cap,
                               num_alive=lambda: int(state.num_alive))
    grown = []

    def record(s, new_cap):
        grown.append(new_cap)
        return s

    monkeypatch.setattr(loop, "grow_capacity", record)
    Trainer._maybe_grow(tr)
    assert grown == ([grows] if grows else [])
    assert tr.capacity_exhausted == int(warns)
    out = capsys.readouterr().out
    assert ("WARNING" in out) == warns
    if warns:
        assert "capacity_exhausted=1" in out


@pytest.fixture(scope="module")
def trained_model(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("dataset"))
    make_colmap_dataset(root, np.random.default_rng(3), n_images=8,
                        width=64, height=48)
    model = str(tmp_path_factory.mktemp("model"))
    train_app.main(["-s", root, "-m", model, "--iterations", "6",
                    "--test_iterations", "6", "--save_iterations", "6",
                    "--densify_from_iter", "100",
                    "--opacity_reset_interval", "1000",
                    "--dup_capacity", "4096", "--max_per_tile", "64",
                    "--chunk", "32", "--disable_viewer", "--quiet", "--eval",
                    "--data_device", "cpu"])
    return model


def test_render_cli_regrows_an_overflowing_view(trained_model, capsys):
    """A render CLI run whose dup_capacity the test view overflows writes
    the PNG of an ample render, byte for byte, and says it rendered
    again."""
    png = os.path.join(trained_model, "test", "ours_6", "renders",
                       "00000.png")
    pngs = {}
    for dup in ("8192", "64"):
        render_app.main(["-m", trained_model, "--quiet", "--skip_train",
                         "--dup_capacity", dup, "--max_per_tile", "64",
                         "--chunk", "32", "--data_device", "cpu"])
        with Image.open(png) as im:
            pngs[dup] = np.asarray(im).copy()
        out = capsys.readouterr().out
        assert ("rendering again with {'dup_capacity'" in out) == (dup == "64")
        assert "WARNING" not in out
    assert pngs["64"].max() > 0
    np.testing.assert_array_equal(pngs["64"], pngs["8192"])


def test_evaluate_regrows_and_keeps_the_raster(capsys):
    """Trainer.evaluate at a dup_capacity its views overflow gives the PSNR
    of an ample evaluation, and leaves the trainer's buffers as they were."""
    tr = port_trainer(dup_capacity=4096)
    tr.train(iterations=3)
    ample = tr.evaluate(tr.train_cams)
    tr.raster = dataclasses.replace(tr.raster, dup_capacity=64)
    capsys.readouterr()
    small = tr.evaluate(tr.train_cams)
    assert "rendering again" in capsys.readouterr().out
    assert small == ample
    assert tr.raster.dup_capacity == 64
    out = tr.render_view(tr.train_cams[0].camera)
    assert not bool(out.overflow) and int(out.num_duplicates) > 64
