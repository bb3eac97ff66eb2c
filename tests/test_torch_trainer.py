"""gs_tpu_torch.train.loop.Trainer against gs_tpu's Trainer (tree layout,
``packed=False``) on the CPU, and its overflow replay.

The scene is tests/test_overflow_replay.py::make_trainer's: four 64x48
views of uniform noise, 50 points, capacity 256, seed 7. Both trainers run
12 iterations in step mode with a sync every 4 and a densify at iteration
10; the port runs its kernel path (the plain versions on CPU tensors), the
JAX package its binned backend. The split noise of the JAX run is recorded
and handed to the port's ``_densify_noise``. The densify threshold sits in
a gap of the JAX run's mean gradients (none within 10 % of it, asserted),
so rounding cannot move a Gaussian across it.

Expected: the same camera sequence, equal alive masks, losses within 1e-5
relative, and every parameter leaf within 2e-4 x its largest magnitude (the
gradient rule of tests/test_torch_train.py) but for at most 1 % of its
values. Those are Adam's sign flips: its update is nearly lr * sign(g), so
a gradient that is zero up to rounding moves a value by +lr in one package
and -lr in the other (tests/test_torch_train.py's docstring). They are held
to test_torch_train.py's bound for that case, 2.01 lr per step (4 of the
1,024 quaternion values, at most 1.08 lr apart after 12 steps)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera
from gs_tpu.data.dataset_readers import CameraInfo as JCameraInfo
from gs_tpu.train.loop import Trainer as JTrainer

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models.gaussian_model import group_lrs
from gs_tpu_torch.render import overflow_changes
from gs_tpu_torch.train.loop import MAX_DUP_CAPACITY, Trainer
from gs_tpu_torch.train.step import StepMetrics

from utils import default_camera


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """At these tiny shapes torch's thread pool gives nothing, and beside
    other test processes its threads oversubscribe the cores (a parallel
    region then waits on threads that are not running)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


W, H = 64, 48
ITERS = 12
THRESHOLD = 3.5e-4
OPT = dict(iterations=30, position_lr_max_steps=30, densify_from_iter=5,
           densification_interval=10, densify_until_iter=25,
           opacity_reset_interval=1000, densify_grad_threshold=THRESHOLD)


def make_data(seed=42):
    """tests/test_overflow_replay.py::make_trainer's draws: four images,
    50 points and their colours."""
    rng = np.random.default_rng(seed)
    images = [rng.uniform(0, 1, (3, H, W)).astype(np.float32)
              for _ in range(4)]
    pts = np.concatenate([rng.uniform(-1, 1, (50, 2)),
                          rng.uniform(3, 5, (50, 1))], 1)
    cols = rng.uniform(0, 1, (50, 3))
    return images, pts, cols


def _views(images, camera, info_cls, loaded_cls):
    return [loaded_cls(camera=camera, info=info_cls(
        uid=i, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=0.8,
        image_path="", image_name=f"v{i}", width=W, height=H),
        image=img, alpha_mask=np.ones((1, H, W), np.float32), invdepth=None,
        depth_mask=None, depth_reliable=False)
        for i, img in enumerate(images)]


def port_trainer(dup_capacity=4096, packed=None, **opt):
    images, pts, cols = make_data()
    fovx = math.radians(60.0)
    cam = make_camera(np.eye(3), np.zeros(3), fovx,
                      focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                      device="cpu")
    tr = Trainer(_views(images, cam, CameraInfo, LoadedCamera),
                 (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                 opt=OptimizationConfig(**dict(OPT, **opt)),
                 pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=dup_capacity,
                                     max_per_tile=512, chunk=32),
                 initial_capacity=256, seed=7, packed=packed)
    tr.sync_every = 4
    return tr


def _record(tr, log):
    """Log each camera pick and each step's loss."""
    pick = tr._next_camera

    def next_camera():
        log["cams"].append(pick())
        return log["cams"][-1]

    tr._next_camera = next_camera
    return lambda i, m, t: log["losses"].append(float(m.loss))


def _params(tr):
    return {k: np.asarray(v.detach().cpu() if isinstance(v, torch.Tensor)
                          else v)
            for k, v in tr.state.params._asdict().items()}


@pytest.fixture(scope="module")
def jax_run():
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, packed=False)
    tr.sync_every = 4
    log = {"cams": [], "losses": [], "noise": [], "grads": []}
    densify = tr._densify

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        g = np.asarray(state.grad_accum / state.denom)
        log["grads"].append(np.where(np.isnan(g), 0.0, g)[
            np.asarray(state.alive)])
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._densify = record_densify
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    return dict(log, alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


def assert_params_close(got, ref, steps=0):
    """Each leaf within 2e-4 x its largest magnitude; with ``steps``, at most
    1 % of its values may instead be Adam sign flips, within 2.01 lr of the
    group per step."""
    opt = OptimizationConfig(**OPT)
    for k, x in ref.items():
        scale = max(float(np.abs(x).max()), 1e-12)
        diff = np.abs(got[k] - x)
        beyond = diff > 2e-4 * scale
        if not steps:
            assert not beyond.any(), (k, float(diff.max()), 2e-4 * scale)
            continue
        lr = max(getattr(group_lrs(opt, 1, 1.0), k),
                 getattr(group_lrs(opt, steps, 1.0), k))
        assert beyond.mean() <= 0.01, (k, int(beyond.sum()), diff.size)
        assert diff.max() <= 2.01 * steps * lr, (k, float(diff.max()), lr)


def test_trainer_matches_jax(jax_run):
    assert len(jax_run["noise"]) == 1, "one densify, at iteration 10"
    g = jax_run["grads"][0]
    assert not (np.abs(g - THRESHOLD) < 0.1 * THRESHOLD).any()
    assert (g >= THRESHOLD).sum() > 10

    tr = port_trainer(packed=False)
    noise = list(jax_run["noise"])
    tr._densify_noise = lambda c: torch.tensor(noise.pop(0))
    log = {"cams": [], "losses": []}
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    assert not noise
    assert log["cams"] == jax_run["cams"]
    np.testing.assert_allclose(log["losses"], jax_run["losses"], rtol=1e-5)
    assert math.isclose(tr.ema_loss, jax_run["ema"], rel_tol=1e-5)
    alive = tr.state.alive.numpy()
    np.testing.assert_array_equal(alive, jax_run["alive"])
    assert alive.sum() > 50
    assert_params_close(_params(tr), jax_run["params"], steps=ITERS)


@pytest.mark.parametrize("block_scan", [False, True])
def test_overflow_replay_matches_no_overflow(block_scan):
    """A run whose buffer overflows ends where one that never overflowed
    does: the window since the last sync is replayed with grown buffers,
    the same cameras and the same densify noise."""
    runs = []
    for dup in (4096, 64):
        tr = port_trainer(dup_capacity=dup, iterations=20,
                          densify_grad_threshold=2e-4)
        tr.train(iterations=20, block_scan=block_scan)
        runs.append(tr)
    ctl, ovf = runs
    assert ctl.raster.dup_capacity == 4096
    assert ovf.raster.dup_capacity > 64, "overflow never triggered"
    assert ovf.overflow_exhausted == 0
    np.testing.assert_array_equal(ctl.state.alive.numpy(),
                                  ovf.state.alive.numpy())
    assert ctl.state.alive.sum() > 50, "no densify in the window"
    assert_params_close(_params(ovf), _params(ctl))
    assert math.isclose(ctl.ema_loss, ovf.ema_loss, rel_tol=1e-5)


def test_replay_exhaustion_flag(monkeypatch, capsys):
    """When 5 consecutive replays still overflow, the trainer keeps the
    truncated updates but records it (counter and warning)."""
    tr = port_trainer(dup_capacity=64)
    bad = StepMetrics(loss=torch.tensor(0.5), l1=torch.tensor(0.5),
                      ssim=torch.tensor(0.0), depth_l1=torch.tensor(0.0),
                      num_duplicates=torch.tensor(10_000),
                      max_tile_len=torch.tensor(100),
                      overflow=torch.tensor(True), n_visible=torch.tensor(10))
    grows = []
    monkeypatch.setattr(tr, "_grow_raster", lambda changes, will_replay:
                        grows.append((dict(changes), will_replay)))
    monkeypatch.setattr(tr, "_replay_window", lambda: bad)
    tr._last_metrics = bad
    tr.sync_metrics()
    assert [w for _, w in grows] == [True] * 4 + [False]
    assert tr.overflow_exhausted == 1
    assert "overflow replay exhausted" in capsys.readouterr().out


def test_overflow_before_the_last_step_is_seen():
    """An overflow at any step of the window, not only the last, makes the
    sync replay it."""
    tr = port_trainer(dup_capacity=4096)
    tr.sync_every = 1000
    tr.step()
    first = tr._last_metrics
    tr.raster = tr.raster.__class__(dup_capacity=64, max_per_tile=512,
                                    chunk=32)
    tr._build_step()
    tr.step()
    tr.raster = tr.raster.__class__(dup_capacity=1 << 14, max_per_tile=512,
                                    chunk=32)
    tr._build_step()
    tr.step()
    assert not bool(first.overflow) and bool(tr._last_metrics.overflow)


def test_overflow_at_the_buffer_limit(capsys):
    """The duplicate buffer grows no further than the binning can address
    (2^24 less 512); an overflow there keeps the truncated updates, counted
    and reported, instead of failing in the binning."""
    tr = port_trainer(dup_capacity=64)
    assert overflow_changes(tr.raster.dup_capacity, tr.raster.max_per_tile,
                            20_000_000, 0) == {"dup_capacity": MAX_DUP_CAPACITY}
    tr.raster = dataclasses.replace(tr.raster, dup_capacity=MAX_DUP_CAPACITY)
    assert overflow_changes(tr.raster.dup_capacity, tr.raster.max_per_tile,
                            20_000_000, 0) == {}
    tr._last_metrics = StepMetrics(
        loss=torch.tensor(0.5), l1=torch.tensor(0.5), ssim=torch.tensor(0.0),
        depth_l1=torch.tensor(0.0), num_duplicates=torch.tensor(20_000_000),
        max_tile_len=torch.tensor(100), overflow=torch.tensor(True),
        n_visible=torch.tensor(10))
    tr.sync_metrics()
    assert tr.overflow_exhausted == 1
    assert tr.raster.dup_capacity == MAX_DUP_CAPACITY == (1 << 24) - 512
    assert "at the dup_capacity limit" in capsys.readouterr().out
