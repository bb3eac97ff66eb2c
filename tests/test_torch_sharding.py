"""The sharded training state on the CPU: the mesh train step and densify
against the one-device ones (as tests/test_sharding.py holds the JAX
package's), and ``Trainer(mesh=LocalGroup(k))`` against the JAX package's
``Trainer(mesh=make_mesh(k), packed=False)`` on the 8 virtual CPU devices
of tests/conftest.py.

The step: one step of the 256-slot, 100-point scene of
tests/test_sharding.py at 64x48. The loss is the one-device loss within
1e-6 relative, and Adam's first moments (0.1 x the gradient after one
step) and the densification statistics within 2e-4 x their largest
magnitude (the gradient rule).

The Trainer: tests/test_torch_trainer.py's run (four 64x48 views, 50
points, capacity 256, 12 iterations in step mode with a sync every 4 and a
densify at 10, the JAX run's split noise handed to the port), held to the
JAX mesh Trainer by that file's rules: the same cameras, losses within
1e-5 relative, equal alive masks, parameters within 2e-4 x max but for
Adam's sign flips.
"""
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
from gs_tpu.parallel.mesh import make_mesh
from gs_tpu.train.loop import Trainer as JTrainer

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.core.camera import focal2fov, make_camera, stack_cameras
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models.gaussian_model import (create_from_pcd,
                                                densify_and_prune, init_state)
from gs_tpu_torch.parallel.mesh import (LocalGroup, gather_state, pad_state,
                                        padded_capacity, shard_state)
from gs_tpu_torch.train.loop import Trainer
from gs_tpu_torch.train.step import make_train_step

from test_torch_trainer import (ITERS, OPT, THRESHOLD, W, H, _params, _record,
                                _views, assert_params_close, make_data)
from utils import default_camera


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _camera():
    fovx = math.radians(60.0)
    return make_camera(np.eye(3), np.zeros(3), fovx,
                       focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                       device="cpu")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.uniform(-1, 1, (100, 2)),
                          rng.uniform(3, 5, (100, 1))], axis=1)
    cols = rng.uniform(0, 1, (100, 3))
    params, alive = create_from_pcd(pts, cols, sh_degree=2, capacity=256,
                                    device="cpu")
    state = init_state(params, alive, num_images=3)
    cams = stack_cameras([_camera()] * 3)
    gt = torch.tensor(np.random.default_rng(1).uniform(0, 1, (3, H, W)),
                      dtype=torch.float32)
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    raster = RasterConfig(dup_capacity=1 << 13, max_per_tile=256, chunk=64)
    return state, cams, gt, opt, raster


def _rel_err(got, ref):
    return float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-12)


@pytest.mark.parametrize("assign", ["stride", "cost"])
@pytest.mark.parametrize("k", [2, 4, 8])
def test_mesh_step_matches_single(setup, k, assign):
    state, cams, gt, opt, raster = setup
    raster = dataclasses.replace(raster, band_assign=assign)
    args = (ModelConfig(), PipelineConfig(), raster, cams, 2.0, 2)
    one = make_train_step(opt, *args)
    mesh = make_train_step(opt, *args, mesh=LocalGroup(k, "cpu"))
    s1, m1 = one(state, 1, gt, iteration=1)
    s2, m2 = mesh(shard_state(state, LocalGroup(k, "cpu")), 1, gt,
                  iteration=1)
    assert not bool(m2.overflow)
    assert math.isclose(float(m1.loss), float(m2.loss), rel_tol=1e-6)
    assert int(m2.n_visible) == int(m1.n_visible)
    assert int(m2.max_band_visible) <= 256 // k
    for name, a, b in zip(s1.m._fields, s1.m, s2.m):
        assert _rel_err(b, a) <= 2e-4, name
    assert _rel_err(s2.grad_accum, s1.grad_accum) <= 2e-4
    assert torch.equal(s2.denom, s1.denom)
    assert torch.equal(s2.max_radii2D, s1.max_radii2D)


def test_mesh_densify_matches_single(setup):
    """The Trainer's densify under a mesh (gather, one-device pass with the
    same noise, shard) is the one-device densify."""
    state, _, _, _, _ = setup
    rng = np.random.default_rng(3)
    state = state._replace(
        grad_accum=torch.tensor(np.abs(rng.normal(0, 1e-3, 256)),
                                dtype=torch.float32),
        denom=torch.ones(256))
    noise = torch.tensor(rng.normal(size=(256, 3)), dtype=torch.float32)
    kw = dict(grad_threshold=2e-4, min_opacity=0.005, extent=2.0,
              percent_dense=0.01, use_size_threshold=False)
    s1, info1 = densify_and_prune(state, noise, **kw)
    for k in (2, 4, 8):
        group = LocalGroup(k, "cpu")
        sharded = shard_state(state, group)
        s2, info2 = densify_and_prune(gather_state(sharded, group), noise,
                                      **kw)
        s2 = gather_state(shard_state(s2, group), group)
        assert int(info2.n_alive) == int(info1.n_alive)
        assert torch.equal(s2.alive, s1.alive)
        assert torch.equal(s2.params.xyz, s1.params.xyz)


def test_pad_and_shard_arithmetic(setup):
    state = setup[0]
    assert padded_capacity(256, 3) == 258 and padded_capacity(256, 4) == 256
    padded = pad_state(state, 3)
    assert padded.capacity == 258 and int(padded.num_alive) == 100
    assert not bool(padded.alive[256:].any())
    with pytest.raises(ValueError, match="divisible"):
        shard_state(state, LocalGroup(3, "cpu"))


# ------------------------------------------------------------ the Trainer

def port_trainer(mesh=None, dup_capacity=4096, initial_capacity=256,
                 raster_kw=None, packed=None, **opt):
    images, pts, cols = make_data()
    tr = Trainer(_views(images, _camera(), CameraInfo, LoadedCamera),
                 (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                 model_cfg=ModelConfig(sh_degree=1, data_device="cpu"),
                 opt=OptimizationConfig(**dict(OPT, **opt)),
                 pipe=PipelineConfig(),
                 raster=RasterConfig(dup_capacity=dup_capacity,
                                     max_per_tile=512, chunk=32,
                                     **(raster_kw or {})),
                 initial_capacity=initial_capacity, seed=7, mesh=mesh,
                 packed=packed)
    tr.sync_every = 4
    return tr


@pytest.fixture(scope="module")
def jax_mesh_run():
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, mesh=make_mesh(2),
                  packed=False)
    tr.sync_every = 4
    log = {"cams": [], "losses": [], "noise": []}
    densify = tr._densify

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._densify = record_densify
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    return dict(log, alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


@pytest.mark.parametrize("k", [2, 4])
def test_mesh_trainer_matches_jax(jax_mesh_run, k):
    """The JAX run shards over 2 devices; the port's over k. Both are the
    one-device training, so every k meets the same reference."""
    assert len(jax_mesh_run["noise"]) == 1, "one densify, at iteration 10"
    tr = port_trainer(mesh=LocalGroup(k, "cpu"), packed=False)
    noise = list(jax_mesh_run["noise"])
    tr._densify_noise = lambda c: torch.tensor(noise.pop(0))
    log = {"cams": [], "losses": []}
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    assert not noise
    assert log["cams"] == jax_mesh_run["cams"]
    np.testing.assert_allclose(log["losses"], jax_mesh_run["losses"],
                               rtol=1e-5)
    assert math.isclose(tr.ema_loss, jax_mesh_run["ema"], rel_tol=1e-5)
    alive = tr.state.alive.numpy()
    np.testing.assert_array_equal(alive, jax_mesh_run["alive"])
    assert alive.sum() > 50 and tr.num_alive() == alive.sum()
    assert_params_close(_params(tr), jax_mesh_run["params"], steps=ITERS)
    assert tr.raster.visible_capacity == 0    # auto: a cap no smaller than
    # a shard is no cap


def test_mesh_trainer_grows_visible_capacity_and_replays():
    """A visible_capacity below a shard's visible count overflows at the
    first sync, grows to the power of two above it and replays the window:
    the run ends where a run with whole-shard gathers does."""
    runs = {}
    for vcap in (-1, 8):
        tr = port_trainer(mesh=LocalGroup(2, "cpu"),
                          raster_kw=dict(visible_capacity=vcap),
                          iterations=16, densify_grad_threshold=2e-4)
        tr.train(iterations=16)
        runs[vcap] = tr
    ctl, grown = runs[-1], runs[8]
    assert ctl.raster.visible_capacity == 0
    assert grown.raster.visible_capacity in (32, 64, 128)
    assert grown.overflow_exhausted == 0
    np.testing.assert_array_equal(ctl.state.alive.numpy(),
                                  grown.state.alive.numpy())
    assert ctl.num_alive() > 50, "no densify in the run"
    assert_params_close(_params(grown), _params(ctl))


def test_mesh_trainer_capacity_growth_matches_single():
    """A densify that fills the capacity grows it (gather, grow, shard) as
    the one-device trainer does: the same capacities, alive masks and
    parameters."""
    runs = []
    for mesh in (None, LocalGroup(2, "cpu")):
        tr = port_trainer(mesh=mesh, initial_capacity=64, iterations=16,
                          densify_grad_threshold=1e-4)
        grows = []
        grow = tr._maybe_grow

        def maybe_grow(*a, _tr=tr, _grows=grows, _grow=grow, **kw):
            _grow(*a, **kw)
            _grows.append(_tr.capacity)

        tr._maybe_grow = maybe_grow
        tr.train(iterations=16)
        runs.append((tr, grows))
    (one, g1), (mesh, g2) = runs
    assert g1 == g2 and max(g1) > 64, (g1, g2)
    assert mesh.capacity == one.capacity == g1[-1]
    np.testing.assert_array_equal(one.state.alive.numpy(),
                                  mesh.state.alive.numpy())
    assert_params_close(_params(mesh), _params(one), steps=16)


# ------------------------------------------------------- the packed layout

@pytest.fixture(scope="module")
def jax_packed_mesh_step(setup):
    """One JAX packed step of the setup state on make_mesh(2), under a
    RasterConfig with bf16_features on: the JAX mesh step does not read the
    flag (``gs_tpu/train/step.py:91-106``), so this is its f32 step."""
    import jax.numpy as jnp
    from gs_tpu.core.camera import stack_cameras as jax_stack_cameras
    from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
    from gs_tpu.models.gaussian_model import TrainState as JTrainState
    from gs_tpu.models.packed_state import pack_state as jax_pack_state
    from gs_tpu.parallel.mesh import shard_state as jax_shard_state
    from gs_tpu.train.step import make_train_step as jax_make_train_step
    from gs_tpu_torch.convert import state_to_numpy

    state, _, gt, _, _ = setup
    d = state_to_numpy(state)
    js = JTrainState(**{k: JGaussianParams(**{f: jnp.asarray(x)
                                             for f, x in v.items()})
                        if k in ("params", "m", "v") else jnp.asarray(v)
                        for k, v in d.items()})
    mesh = make_mesh(2)
    step = jax_make_train_step(
        JOptimizationConfig(iterations=100, position_lr_max_steps=100),
        JModelConfig(), JPipelineConfig(),
        JRasterConfig(backend="binned", dup_capacity=1 << 13,
                      max_per_tile=256, chunk=64, bf16_features=True),
        jax_stack_cameras([default_camera(W, H)] * 3), spatial_lr_scale=2.0,
        max_sh_degree=2, mesh=mesh, packed=True)
    out, m = step(jax_shard_state(jax_pack_state(js), mesh), jnp.int32(1),
                  jnp.asarray(gt.numpy()), None, None, None, jnp.float32(0.0),
                  jnp.int32(1), jax.random.key(0))
    return jax.tree.map(np.asarray, out._asdict()), float(m.loss)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16-config"])
@pytest.mark.parametrize("k", [2, 4])
def test_packed_mesh_step_matches_jax(setup, jax_packed_mesh_step, k, bf16):
    """The port's packed mesh step on LocalGroup(k) against JAX's on
    make_mesh(2) (both are the one-device step): the loss within 1e-5
    relative, Adam's first moments and the densification statistics under
    the gradient rule. With ``bf16_features`` in the config the port's mesh
    step is its f32 mesh step, bit for bit, as JAX's is."""
    from gs_tpu_torch.models.packed_state import PackedState, pack_state
    state, cams, gt, opt, raster = setup
    ref, ref_loss = jax_packed_mesh_step
    group = LocalGroup(k, "cpu")
    args = (ModelConfig(), PipelineConfig())
    runs = []
    for flag in sorted({False, bf16}):
        r = dataclasses.replace(raster, bf16_features=flag)
        step = make_train_step(opt, *args, r, cams, 2.0, 2, mesh=group,
                               packed=True)
        runs.append(step(shard_state(pack_state(state), group), 1, gt,
                         iteration=1))
    s2, m2 = runs[-1]
    assert isinstance(s2, PackedState) and not bool(m2.overflow)
    for a, b in zip(runs[0][0], s2):
        assert torch.equal(a, b)
    assert math.isclose(float(m2.loss), ref_loss, rel_tol=1e-5)
    for name in ("m", "grad_accum"):
        want = ref[name]
        err = float(np.abs(getattr(s2, name).numpy() - want).max())
        assert err <= 2e-4 * float(np.abs(want).max()), name
    for name in ("denom", "max_radii2D", "alive", "step"):
        np.testing.assert_array_equal(getattr(s2, name).numpy(), ref[name],
                                      err_msg=name)


@pytest.fixture(scope="module")
def jax_packed_mesh_run():
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, mesh=make_mesh(2),
                  packed=True)
    tr.sync_every = 4
    log = {"cams": [], "losses": [], "noise": []}
    densify = tr._densify

    def record_densify(state, key, use_size_threshold):
        log["noise"].append(np.asarray(
            jax.random.normal(key, (state.capacity, 3))))
        return densify(state, key, use_size_threshold=use_size_threshold)

    tr._densify = record_densify
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    return dict(log, alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


def test_packed_mesh_trainer_matches_jax(jax_packed_mesh_run):
    """The port's default (packed) Trainer on LocalGroup(2) against JAX's
    packed mesh Trainer, by test_mesh_trainer_matches_jax's rules."""
    from gs_tpu_torch.models.packed_state import PackedState
    ref = jax_packed_mesh_run
    assert len(ref["noise"]) == 1, "one densify, at iteration 10"
    tr = port_trainer(mesh=LocalGroup(2, "cpu"))
    assert isinstance(tr.state, PackedState)
    noise = list(ref["noise"])
    tr._densify_noise = lambda c: torch.tensor(noise.pop(0))
    log = {"cams": [], "losses": []}
    tr.train(iterations=ITERS, on_step=_record(tr, log), log_every=1)
    assert not noise and log["cams"] == ref["cams"]
    np.testing.assert_allclose(log["losses"], ref["losses"], rtol=1e-5)
    assert math.isclose(tr.ema_loss, ref["ema"], rel_tol=1e-5)
    alive = tr.state.alive.numpy()
    np.testing.assert_array_equal(alive, ref["alive"])
    assert alive.sum() > 50 and tr.num_alive() == alive.sum()
    assert_params_close(_params(tr), ref["params"], steps=ITERS)


def test_packed_state_shards_by_columns(setup):
    """A PackedState's blocks split on their columns, its [C] tensors on
    their only axis; padding grows it packed."""
    from gs_tpu_torch.models.packed_state import pack_state
    ps = pack_state(setup[0])
    padded = pad_state(ps, 3)
    assert padded.capacity == 258 and padded.packed.shape == (40, 258)
    assert int(padded.num_alive) == 100
    assert torch.equal(padded.packed[:, :256], ps.packed)
    assert torch.equal(padded.params.quat[256:, 0], torch.ones(2))
    group = LocalGroup(2, "cpu")
    assert shard_state(ps, group) is ps and gather_state(ps, group) is ps

    class Rank1:
        """Rank 1 of two processes; its all-gather returns its own shard
        twice."""
        size, local = 2, [1]

        @staticmethod
        def gather_values(xs):
            return torch.stack([xs[0], xs[0]])

    shard = shard_state(ps, Rank1)
    assert torch.equal(shard.packed, ps.packed[:, 128:])
    assert torch.equal(shard.m, ps.m[:, 128:])
    assert torch.equal(shard.alive, ps.alive[128:])
    assert torch.equal(shard.exposure, ps.exposure)
    back = gather_state(shard, Rank1)
    assert back.packed.shape == ps.packed.shape
    assert torch.equal(back.packed, torch.cat([shard.packed] * 2, 1))
    assert torch.equal(back.alive, torch.cat([shard.alive] * 2))
    assert back.alive.dtype == torch.bool
