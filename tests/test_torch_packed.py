"""The packed [R, C] state layout of gs_tpu_torch against gs_tpu's on the CPU.

Inputs are made from numpy seeds and carried across as numpy arrays
(``gs_tpu_torch/convert.py``). What is held, and to what:

* ``layout(d)`` and ``degree_from_rows`` for d 0-4, field for field;
* ``pack_params``/``unpack_params`` bitwise to JAX's (degrees 0, 1, 3),
  ``mask_sh_rows`` for degrees 0-3 exactly (atol 0), ``group_lr_rows``
  bitwise;
* ``adam_update_packed`` dense and sparse bitwise against the port's tree
  ``adam_update`` (the same elementwise ops) and within 1e-6 relative of
  JAX's (XLA fuses the same formula);
* ``reset_opacity_packed``, ``densify_and_prune_packed`` (JAX's split
  noise handed to the port), ``grow_capacity_packed`` and
  ``compact_packed`` against JAX's packed functions: masks and counts
  equal, values within 1e-6 (``tests/test_torch_density.py``'s rule);
* ``preprocess_packed`` values within 1e-5 and gradients within atol 1e-4,
  rtol 1e-3 (``tests/test_packed.py:50-91``), and its backward graph
  reaching the block through the one ``_ReadRows`` Function with no
  ``SelectBackward0``;
* three packed training steps against JAX's packed step (the rules of
  ``tests/test_torch_train.py``) and against the port's tree step (JAX's
  packed-against-tree rule, atol 2e-5 rtol 1e-3);
* ``Trainer(packed=True)`` against JAX's ``Trainer(packed=True)`` through a
  densify, the port's run overflowing its buffer and replaying (the rules
  of ``tests/test_torch_trainer.py``);
* a ``PackedState`` checkpoint that reloads bitwise, and a JAX
  ``PackedState`` carried over;
* ``project_points``, ``compute_cov2d`` and ``mark_visible`` against JAX.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.core import packed as jpk
from gs_tpu.core import project as jproject
from gs_tpu.core.camera import stack_cameras as jax_stack_cameras
from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
from gs_tpu.core.gaussians import covariance_3d as jax_covariance_3d
from gs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera
from gs_tpu.data.dataset_readers import CameraInfo as JCameraInfo
from gs_tpu.models import gaussian_model as jgm
from gs_tpu.models import packed_state as jps
from gs_tpu.train.loop import Trainer as JTrainer
from gs_tpu.train.step import make_train_step as jax_make_train_step

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import (camera_from_numpy, packed_state_from_numpy,
                                  packed_state_to_numpy, params_from_numpy,
                                  state_from_numpy)
from gs_tpu_torch.core import packed as tpk
from gs_tpu_torch.core import project as tproject
from gs_tpu_torch.core.camera import stack_cameras
from gs_tpu_torch.core.gaussians import GaussianParams, covariance_3d
from gs_tpu_torch.data.camera_utils import LoadedCamera
from gs_tpu_torch.data.dataset_readers import CameraInfo
from gs_tpu_torch.models import gaussian_model as tgm
from gs_tpu_torch.models import packed_state as tps
from gs_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gs_tpu_torch.train.step import make_train_step

from test_torch_train import CAM_FIELDS, make_scene
from test_torch_trainer import (ITERS, OPT, THRESHOLD, H, W, _params,
                                _record, _views, assert_params_close,
                                make_data, port_trainer)
from utils import default_camera, random_params

FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(p):
    return {f: np.asarray(getattr(p, f)) for f in FIELDS}


def _jparams(arrays):
    return JGaussianParams(**{f: jnp.asarray(v) for f, v in arrays.items()})


def _scene(seed=0, n=80, cap=128, sh_degree=3):
    """tests/test_packed.py::_scene: n random Gaussians padded with dead
    slots to cap, as numpy arrays, and the alive mask."""
    rng = np.random.default_rng(seed)
    p = _np_params(random_params(rng, n, sh_degree=sh_degree))
    out = {f: np.concatenate([v, np.zeros((cap - n,) + v.shape[1:],
                                          np.float32)]) for f, v in p.items()}
    out["quat"][n:, 0] = 1.0
    out["log_scale"][n:] = -10.0
    out["logit_opacity"][n:] = -10.0
    return out, np.arange(cap) < n


def _port_cam(jcam):
    return camera_from_numpy({k: np.asarray(getattr(jcam, k))
                              for k in CAM_FIELDS}, jcam.width, jcam.height,
                             "cpu")


# ------------------------------------------------------------- the layout

@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_layout_and_degree_from_rows(deg):
    lay = tpk.layout(deg)
    assert tuple(lay) == tuple(jpk.layout(deg))
    assert lay.rows % 8 == 0 and lay.n_channels == 11 + 3 * (deg + 1) ** 2
    assert tps.degree_from_rows(lay.rows) == jps.degree_from_rows(lay.rows) \
        == deg
    np.testing.assert_array_equal(tpk.sh_band_index(lay),
                                  np.asarray(jpk.sh_band_index(lay)))


def test_degree_from_rows_rejects():
    with pytest.raises(ValueError, match="no SH degree"):
        tps.degree_from_rows(30)


@pytest.mark.parametrize("deg", [0, 1, 3])
def test_pack_unpack_bitwise(deg):
    arrays = _np_params(random_params(np.random.default_rng(deg), 40,
                                      sh_degree=deg))
    ref = np.asarray(jpk.pack_params(_jparams(arrays)))
    got = tpk.pack_params(params_from_numpy(arrays, "cpu"))
    assert got.shape == ref.shape == (tpk.layout(deg).rows, 40)
    np.testing.assert_array_equal(got.numpy(), ref)
    back = tpk.unpack_params(got, deg)
    jback = jpk.unpack_params(jnp.asarray(ref), deg)
    for f in FIELDS:
        x = getattr(back, f)
        assert x.is_contiguous(), f
        np.testing.assert_array_equal(x.numpy(), np.asarray(getattr(jback, f)))
        np.testing.assert_array_equal(x.numpy(), arrays[f])


@pytest.mark.parametrize("active", [0, 1, 2, 3])
def test_mask_sh_rows(active):
    from gs_tpu_torch.train.step import mask_sh_rest
    arrays, _ = _scene()
    lay = tpk.layout(3)
    block = tpk.pack_params(params_from_numpy(arrays, "cpu"))
    got = tpk.mask_sh_rows(block, lay, active)
    ref = jpk.mask_sh_rows(jnp.asarray(block.numpy()), jpk.layout(3),
                           jnp.int32(active))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=0, rtol=0)
    tree = tpk.pack_params(mask_sh_rest(params_from_numpy(arrays, "cpu"),
                                        active))
    np.testing.assert_allclose(got.numpy(), tree.numpy(), atol=0, rtol=0)


@pytest.mark.parametrize("step", [1, 500, 29000])
def test_group_lr_rows(step):
    lay = tpk.layout(3)
    opt = OptimizationConfig()
    got = tps.group_lr_rows(lay, opt, step, 2.5, device="cpu")
    ref = jps.group_lr_rows(jpk.layout(3), JOptimizationConfig(),
                            jnp.int32(step), 2.5)
    assert got.shape == (lay.rows, 1) and got.dtype == torch.float32
    # the port's tree rates, bitwise; JAX's schedule runs on the device, in
    # float32 ops of another order (7e-8 relative at step 1)
    one = tpk.unpack_params(torch.zeros(lay.rows, 1), 3)
    want = tpk.pack_params(GaussianParams(*[
        torch.full_like(t, rate)
        for t, rate in zip(one, tgm.group_lrs(opt, step, 2.5))]))
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=0)


# ---------------------------------------------------------------- Adam

def _adam_inputs(seed=1, cap=64, deg=2):
    """A random packed state (moments too, step 4) and a gradient block."""
    rng = np.random.default_rng(seed)
    lay = tpk.layout(deg)
    arrays, alive = _scene(seed, n=50, cap=cap, sh_degree=deg)
    st = jgm.init_state(_jparams(arrays), jnp.asarray(alive), num_images=2)
    ps = jps.pack_state(st)
    real = (np.arange(lay.rows) < lay.n_channels)[:, None]
    ps = ps._replace(
        m=jnp.asarray(real * rng.normal(0, 1e-3, ps.m.shape), jnp.float32),
        v=jnp.asarray(real * rng.uniform(0, 1e-6, ps.v.shape), jnp.float32),
        step=jnp.int32(4))
    # the padding rows of a gradient are zero (core/packed.py::_ReadRows)
    grad = (real * rng.normal(0, 1e-3, (lay.rows, cap))).astype(np.float32)
    visible = rng.uniform(size=cap) < 0.6
    return lay, ps, grad, visible


@pytest.mark.parametrize("sparse", [False, True])
def test_adam_update_packed(sparse):
    lay, jstate, grad, visible = _adam_inputs()
    opt = OptimizationConfig()
    ps = packed_state_from_numpy(jax.tree.map(np.asarray, jstate._asdict()),
                                 "cpu")
    lr = tps.group_lr_rows(lay, opt, 7, 1.5, device="cpu")
    vis = torch.tensor(visible) if sparse else None
    got = tps.adam_update_packed(ps, torch.tensor(grad), lr, vis)
    assert int(got.step) == 5

    # the port's tree layout: the same elementwise ops, bitwise
    tree = tgm.adam_update(tps.unpack_state(ps),
                           tpk.unpack_params(torch.tensor(grad), lay.sh_degree),
                           tgm.group_lrs(opt, 7, 1.5), vis)
    tp = tps.pack_state(tree)
    for k in ("packed", "m", "v"):
        assert torch.equal(getattr(got, k), getattr(tp, k)), k

    ref = jps.adam_update_packed(
        jstate, jnp.asarray(grad),
        jps.group_lr_rows(jpk.layout(2), JOptimizationConfig(), jnp.int32(7),
                          1.5),
        jnp.asarray(visible) if sparse else None)
    for k in ("packed", "m", "v"):
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(ref, k)), rtol=1e-6,
                                   atol=1e-12, err_msg=k)
    if sparse:
        hidden = ~visible
        np.testing.assert_array_equal(got.packed.numpy()[:, hidden],
                                      ps.packed.numpy()[:, hidden])


# ------------------------------------------------------ cold-path functions

def _density_state(seed=9):
    """tests/test_packed.py::test_densify_reset_grow_packed_equal_unpacked's
    state: 60 of 128 slots alive, seeded densification statistics."""
    rng = np.random.default_rng(seed)
    arrays, alive = _scene(seed, n=60, cap=128)
    st = jgm.init_state(_jparams(arrays), jnp.asarray(alive), num_images=1)
    st = st._replace(
        grad_accum=jnp.asarray(rng.uniform(0, 1e-2, (128,)), jnp.float32),
        denom=jnp.ones((128,), jnp.float32),
        m=jax.tree.map(lambda x: jnp.asarray(
            rng.normal(0, 1e-3, x.shape), jnp.float32), st.m))
    return jps.pack_state(st)


def _assert_packed_close(got, ref, atol=1e-6):
    ref = jax.tree.map(np.asarray, ref._asdict())
    got = packed_state_to_numpy(got)
    for k, x in ref.items():
        assert got[k].shape == x.shape and got[k].dtype == x.dtype, k
        if x.dtype == np.float32:
            np.testing.assert_allclose(got[k], x, atol=atol, rtol=0,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(got[k], x, err_msg=k)


def test_densify_reset_grow_compact_packed():
    jstate = _density_state()
    ps = packed_state_from_numpy(jax.tree.map(np.asarray, jstate._asdict()),
                                 "cpu")
    # extent 10: Gaussians below 0.1 clone, above split
    kw = dict(grad_threshold=2e-3, min_opacity=0.005, extent=10.0,
              percent_dense=0.01, use_size_threshold=True)
    key = jax.random.key(9)
    noise = torch.tensor(np.asarray(jax.random.normal(key, (128, 3))))
    jd, jinfo = jps.densify_and_prune_packed(jstate, key, **kw)
    td, tinfo = tps.densify_and_prune_packed(ps, noise, **kw)
    for name in jinfo._fields:
        assert int(getattr(tinfo, name)) == int(getattr(jinfo, name)), name
    assert int(tinfo.n_cloned) > 0 and int(tinfo.n_split) > 0
    _assert_packed_close(td, jd)

    _assert_packed_close(tps.reset_opacity_packed(td),
                         jps.reset_opacity_packed(jd), atol=1e-5)
    _assert_packed_close(tps.grow_capacity_packed(td, 256),
                         jps.grow_capacity_packed(jd, 256))
    for cap in (None, 128):
        _assert_packed_close(tps.compact_packed(td, cap),
                             jps.compact_packed(jd, cap))


def test_packed_state_properties():
    ps = packed_state_from_numpy(
        jax.tree.map(np.asarray, _density_state()._asdict()), "cpu")
    assert ps.capacity == 128 and ps.sh_degree == 3
    assert int(ps.num_alive) == 60
    for f in FIELDS:
        assert torch.equal(getattr(ps.params, f),
                           getattr(tps.unpack_state(ps).params, f)), f


# ----------------------------------------------------------- preprocess

def _stats(pr, alive):
    m = alive
    return ((torch.where(m[:, None], pr.rgb, 0) ** 2).sum()
            + (torch.where(m[:, None], pr.conic, 0) ** 2).sum() * 1e-4
            + (torch.where(m[:, None], pr.mean2d, 0) ** 2).sum() * 1e-4
            + (torch.where(m, pr.opacity, 0) ** 2).sum())


def _jstats(pr, alive):
    m = alive
    return (jnp.sum(jnp.where(m[:, None], pr.rgb, 0) ** 2)
            + jnp.sum(jnp.where(m[:, None], pr.conic, 0) ** 2) * 1e-4
            + jnp.sum(jnp.where(m[:, None], pr.mean2d, 0) ** 2) * 1e-4
            + jnp.sum(jnp.where(m, pr.opacity, 0) ** 2))


def test_preprocess_packed_matches_jax():
    arrays, alive = _scene()
    jcam = default_camera()
    cam = _port_cam(jcam)
    jblock = jpk.pack_params(_jparams(arrays))
    jal = jnp.asarray(alive)
    kw = dict(sh_degree=3, active_sh_degree=3, antialiasing=True)
    ref = jproject.preprocess_packed(jblock, jcam, alive=jal, **kw)
    block = torch.tensor(np.asarray(jblock), requires_grad=True)
    al = torch.tensor(alive)
    got = tproject.preprocess_packed(block, cam, alive=al, **kw)
    for f, a, b in zip(ref._fields, ref, got):
        np.testing.assert_allclose(b.detach().numpy().astype(np.float32)[alive],
                                   np.asarray(a, np.float32)[alive],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    (g,) = torch.autograd.grad(_stats(got, al), [block])
    jg = jax.grad(lambda q: _jstats(jproject.preprocess_packed(
        q, jcam, alive=jal, **kw), jal))(jblock)
    np.testing.assert_allclose(g.numpy()[:, alive], np.asarray(jg)[:, alive],
                               atol=1e-4, rtol=1e-3)
    # the packed and the tree preprocess of the port: the same values
    tree = tproject.preprocess(params_from_numpy(arrays, "cpu"), cam,
                               active_sh_degree=3, antialiasing=True, alive=al)
    for f, a, b in zip(tree._fields, tree, got):
        assert torch.equal(a, b.detach()), f


def _backward_nodes(t):
    seen, stack, names = set(), [t.grad_fn], []
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    return names


def test_preprocess_packed_backward_is_one_read():
    arrays, alive = _scene(n=20, cap=32)
    cam = _port_cam(default_camera())
    al = torch.tensor(alive)
    block = tpk.pack_params(params_from_numpy(arrays, "cpu")).requires_grad_()
    loss = _stats(tproject.preprocess_packed(
        block, cam, sh_degree=3, active_sh_degree=3, alive=al), al)
    names = _backward_nodes(loss)
    assert names.count("_ReadRowsBackward") == 1, names
    assert "SelectBackward0" not in names
    # the tree layout reads its channels by select, one node each
    leaves = [t.requires_grad_() for t in params_from_numpy(arrays, "cpu")]
    tree = _stats(tproject.preprocess(GaussianParams(*leaves), cam,
                                      active_sh_degree=3, alive=al), al)
    assert _backward_nodes(tree).count("SelectBackward0") >= 59
    # a row the loss never reads gets a zero row of the block's gradient
    rows = tpk.read_rows(block, 4, 3)
    (g,) = torch.autograd.grad(rows[1].sum(), [block])
    want = torch.zeros_like(block)
    want[5] = 1.0
    assert torch.equal(g, want)


def test_projection_helpers_match_jax():
    arrays, _ = _scene(n=100, cap=100)
    arrays["xyz"][:10, 2] = np.linspace(-1.0, 0.3, 10)   # behind and near
    jcam = default_camera()
    cam = _port_cam(jcam)
    xyz = torch.tensor(arrays["xyz"])
    pv, pix = tproject.project_points(cam, xyz)
    jpv, jpix = jproject.project_points(jcam, jnp.asarray(arrays["xyz"]))
    np.testing.assert_allclose(pv.numpy(), np.asarray(jpv), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(pix.numpy(), np.asarray(jpix), atol=1e-3,
                               rtol=1e-6)
    vis = tproject.mark_visible(cam, xyz)
    np.testing.assert_array_equal(vis.numpy(), np.asarray(
        jproject.mark_visible(jcam, jnp.asarray(arrays["xyz"]))))
    assert 0 < int(vis.sum()) < 100
    cov3 = covariance_3d(torch.exp(torch.tensor(arrays["log_scale"])), 1.0,
                         torch.tensor(arrays["quat"]))
    jcov3 = jax_covariance_3d(jnp.exp(jnp.asarray(arrays["log_scale"])), 1.0,
                              jnp.asarray(arrays["quat"]))
    got = tproject.compute_cov2d(cam, pv, cov3)
    ref = jproject.compute_cov2d(jcam, jpv, jcov3)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-6)
    # the matrix form is the channel form of the preprocess
    ch = tproject._cov2d_channels(cam, pv[:, 0], pv[:, 1], pv[:, 2],
                                  tuple(cov3[:, i] for i in range(6)))
    np.testing.assert_allclose(got[0].numpy(),
                               torch.stack(ch[:3], -1).numpy(), rtol=1e-4,
                               atol=1e-6)


# ------------------------------------------------------ the training step

STEPS = 3


@pytest.fixture(scope="module")
def packed_steps():
    """JAX's packed step, three iterations from tests/test_torch_train.py's
    scene, and the port's packed and tree steps from the same state."""
    jcam, gt, state0 = make_scene()
    jopt = JOptimizationConfig(iterations=100, position_lr_max_steps=100)
    jraster = JRasterConfig(backend="binned", dup_capacity=1 << 13,
                            max_per_tile=256, chunk=64)
    jstep = jax_make_train_step(jopt, JModelConfig(), JPipelineConfig(),
                                jraster, jax_stack_cameras([jcam]),
                                spatial_lr_scale=1.0, max_sh_degree=3,
                                packed=True)
    js = jps.pack_state(jgm.TrainState(**{
        k: _jparams(v) if k in ("params", "m", "v") else jnp.asarray(v)
        for k, v in state0.items()}))
    ref = {"losses": [], "states": []}
    for it in range(1, STEPS + 1):
        js, m = jstep(js, jnp.int32(0), gt, None, None, None,
                      jnp.float32(0.0), jnp.int32(it), jax.random.key(it))
        ref["losses"].append(float(m.loss))
        ref["states"].append(jax.tree.map(np.asarray, js._asdict()))

    cams = stack_cameras([_port_cam(jcam)])
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    raster = RasterConfig(dup_capacity=1 << 13, max_per_tile=256, chunk=64)
    runs = {}
    for packed in (True, False):
        step = make_train_step(opt, ModelConfig(), PipelineConfig(), raster,
                               cams, spatial_lr_scale=1.0, max_sh_degree=3,
                               packed=packed)
        st = state_from_numpy(state0, "cpu")
        if packed:
            st = tps.pack_state(st)
        losses, states = [], []
        for it in range(1, STEPS + 1):
            st, m = step(st, 0, torch.tensor(np.asarray(gt)), iteration=it)
            assert not bool(m.overflow)
            losses.append(float(m.loss))
            states.append(st)
        runs[packed] = (losses, states)
    return opt, ref, runs


def test_packed_step_matches_jax(packed_steps):
    opt, ref, runs = packed_steps
    losses, states = runs[True]
    assert isinstance(states[-1], tps.PackedState)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
    lay = tpk.layout(3)
    # step 1: m_1 = 0.1 g, each group held to the gradient rule
    got_m = tpk.unpack_params(states[0].m, 3)
    ref_m = jpk.unpack_params(jnp.asarray(ref["states"][0]["m"]), 3)
    for f in FIELDS:
        want = np.asarray(getattr(ref_m, f))
        np.testing.assert_allclose(getattr(got_m, f).numpy(), want,
                                   atol=2e-4 * max(np.abs(want).max(), 1e-12),
                                   rtol=0, err_msg=f)
    end, ref_end = packed_state_to_numpy(states[-1]), ref["states"][-1]
    for k in ("step", "alive", "denom", "max_radii2D"):
        np.testing.assert_array_equal(end[k], ref_end[k], err_msg=k)
    np.testing.assert_array_equal(end["packed"][lay.n_channels:], 0)
    got_p = tpk.unpack_params(torch.tensor(end["packed"]), 3)
    ref_p = jpk.unpack_params(jnp.asarray(ref_end["packed"]), 3)
    lrs1, lrs3 = (tgm.group_lrs(opt, s, 1.0)._asdict() for s in (1, STEPS))
    for f in FIELDS:
        lr = max(lrs1[f], lrs3[f])
        diff = np.abs(getattr(got_p, f).numpy() - np.asarray(getattr(ref_p, f)))
        assert diff.max() <= 2.01 * STEPS * lr, (f, diff.max(), lr)
        assert (diff > 1e-2 * lr).mean() <= 0.01, f


def test_packed_step_matches_tree_step(packed_steps):
    _, _, runs = packed_steps
    (pl, ps), (tl, ts) = runs[True], runs[False]
    np.testing.assert_allclose(pl, tl, rtol=1e-5)
    un = tps.unpack_state(ps[-1])
    for name, a, b in zip(ts[-1]._fields, ts[-1], un):
        pairs = zip(a, b) if isinstance(a, GaussianParams) else [(a, b)]
        for x, y in pairs:
            np.testing.assert_allclose(y.numpy(), x.numpy(), atol=2e-5,
                                       rtol=1e-3, err_msg=name)


# ------------------------------------------------------------ the Trainer

@pytest.fixture(scope="module")
def jax_packed_run():
    images, pts, cols = make_data()
    tr = JTrainer(_views(images, default_camera(W, H), JCameraInfo,
                         JLoadedCamera),
                  (pts, cols, np.zeros_like(pts)), spatial_lr_scale=1.0,
                  model_cfg=JModelConfig(sh_degree=1),
                  opt=JOptimizationConfig(**OPT), pipe=JPipelineConfig(),
                  raster=JRasterConfig(backend="binned", dup_capacity=4096,
                                       max_per_tile=512, chunk=32),
                  initial_capacity=256, seed=7, packed=True)
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
    assert isinstance(tr.state, jps.PackedState)
    return dict(log, alive=np.asarray(tr.state.alive), params=_params(tr),
                ema=tr.ema_loss)


def test_packed_trainer_matches_jax(jax_packed_run, capsys):
    """The port trains packed (its default) from a buffer of 64 entries:
    the first sync overflows, the window replays with grown buffers (and
    the densify at 10 with it), and the run meets JAX's packed run."""
    ref = jax_packed_run
    assert len(ref["noise"]) == 1, "one densify, at iteration 10"
    g = ref["grads"][0]
    assert not (np.abs(g - THRESHOLD) < 0.1 * THRESHOLD).any()
    tr = port_trainer(dup_capacity=64)
    assert tr.packed and isinstance(tr.state, tps.PackedState)
    tr._densify_noise = lambda c: torch.tensor(ref["noise"][0])
    # each iteration's camera and loss, the replayed ones overwriting
    # those of the truncated window
    cams, losses = {}, {}
    pick, step = tr._next_camera, tr.train_step

    def next_camera():
        cams[tr.iteration] = pick()
        return cams[tr.iteration]

    def train_step(*a, **kw):
        st, m = tr._step_now(*a, **kw)
        losses[tr.iteration] = float(m.loss)
        return st, m

    tr._next_camera = next_camera
    tr._step_now = step
    tr._build_step = lambda b=tr._build_step: (
        b(), setattr(tr, "_step_now", tr.train_step),
        setattr(tr, "train_step", train_step))
    tr.train_step = train_step
    tr.train(iterations=ITERS)
    assert tr.raster.dup_capacity > 64, "no overflow"
    assert tr.overflow_exhausted == 0
    assert "binning overflow; replaying" in capsys.readouterr().out
    assert isinstance(tr.state, tps.PackedState)
    assert [cams[i] for i in range(1, ITERS + 1)] == ref["cams"]
    np.testing.assert_allclose([losses[i] for i in range(1, ITERS + 1)],
                               ref["losses"], rtol=1e-5)
    assert math.isclose(tr.ema_loss, ref["ema"], rel_tol=1e-5)
    alive = tr.state.alive.numpy()
    np.testing.assert_array_equal(alive, ref["alive"])
    assert alive.sum() > 50
    assert_params_close(_params(tr), ref["params"], steps=ITERS)


def test_packed_trainer_matches_tree_trainer():
    """The port's two layouts train alike: 20 iterations through a densify,
    the same alive masks, parameters within the Trainer rule."""
    runs = [port_trainer(packed=p, iterations=20,
                         densify_grad_threshold=2e-4) for p in (True, False)]
    for tr in runs:
        tr.train(iterations=20)
    pk, tree = runs
    assert isinstance(pk.state, tps.PackedState)
    assert isinstance(tree.state, tgm.TrainState)
    np.testing.assert_array_equal(pk.state.alive.numpy(),
                                  tree.state.alive.numpy())
    assert tree.num_alive() > 50
    assert_params_close(_params(pk), _params(tree), steps=20)
    assert math.isclose(pk.ema_loss, tree.ema_loss, rel_tol=1e-5)


# ----------------------------------------------- checkpoints and carry-over

def test_packed_checkpoint_roundtrip(tmp_path):
    ps = packed_state_from_numpy(
        jax.tree.map(np.asarray, _density_state()._asdict()), "cpu")
    path = str(tmp_path / "chkpnt5.pth")
    save_checkpoint(path, ps, 5, 2.5)
    back, it, slrs = load_checkpoint(path, device="cpu")
    assert (it, slrs) == (5, 2.5) and isinstance(back, tgm.TrainState)
    again = tps.pack_state(back)
    for k in ps._fields:
        a, b = getattr(ps, k), getattr(again, k)
        assert a.dtype == b.dtype and torch.equal(a, b), k


def test_jax_packed_state_carries_over():
    jstate = _density_state()
    ps = packed_state_from_numpy(jax.tree.map(np.asarray, jstate._asdict()),
                                 "cpu")
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ps.params, f).numpy(),
                                      np.asarray(getattr(jstate.params, f)))
    jcam = default_camera()
    kw = dict(sh_degree=3, active_sh_degree=3)
    ref = jproject.preprocess_packed(jstate.packed, jcam, alive=jstate.alive,
                                     **kw)
    got = tproject.preprocess_packed(ps.packed, _port_cam(jcam),
                                     alive=ps.alive, **kw)
    alive = np.asarray(jstate.alive)
    for f, a, b in zip(ref._fields, ref, got):
        np.testing.assert_allclose(b.numpy().astype(np.float32)[alive],
                                   np.asarray(a, np.float32)[alive],
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    back = packed_state_to_numpy(ps)
    for k, x in jstate._asdict().items():
        np.testing.assert_array_equal(back[k], np.asarray(x), err_msg=k)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_packed_step_matches_tree(cuda_device):
    """Three steps of tests/test_torch_train.py's scene through the kernels
    on the card, packed against tree: losses within 1e-5, the unpacked
    state within atol 2e-5, rtol 1e-3."""
    jcam, gt, state0 = make_scene()
    cams = stack_cameras([camera_from_numpy(
        {k: np.asarray(getattr(jcam, k)) for k in CAM_FIELDS}, W, H,
        cuda_device)])
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    raster = RasterConfig(dup_capacity=1 << 13, max_per_tile=256, chunk=64)
    gtt = torch.tensor(np.asarray(gt), device=cuda_device)
    out = {}
    for packed in (True, False):
        step = make_train_step(opt, ModelConfig(), PipelineConfig(), raster,
                               cams, spatial_lr_scale=1.0, max_sh_degree=3,
                               packed=packed)
        st = state_from_numpy(state0, cuda_device)
        st = tps.pack_state(st) if packed else st
        losses = []
        for it in range(1, STEPS + 1):
            st, m = step(st, 0, gtt, iteration=it)
            assert not bool(m.overflow)
            losses.append(float(m.loss))
        out[packed] = (losses, tps.unpack_state(st) if packed else st)
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5)
    for a, b in zip(out[False][1], out[True][1]):
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            np.testing.assert_allclose(y.cpu().numpy(), x.cpu().numpy(),
                                       atol=2e-5, rtol=1e-3)
