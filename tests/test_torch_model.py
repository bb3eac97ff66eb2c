"""The training state's parts against the JAX package, from the same numpy
inputs: init_state, group_lrs, dense and sparse Adam, the exposure
optimizer, the densification statistics, the SH ramp mask, the exposure
transform, the camera batch and the state carried across both ways.
Elementwise float32 math in both: held to 1e-6 relative."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs_tpu.config import OptimizationConfig as JOptimizationConfig
from gs_tpu.core.camera import stack_cameras as jax_stack_cameras
from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
from gs_tpu.models import gaussian_model as jgm
from gs_tpu.train.step import apply_exposure as jax_apply_exposure
from gs_tpu.train.step import mask_sh_rest as jax_mask_sh_rest

from gs_tpu_torch.config import OptimizationConfig
from gs_tpu_torch.convert import (camera_from_numpy, params_from_numpy,
                                  state_from_numpy, state_to_numpy)
from gs_tpu_torch.core.camera import stack_cameras
from gs_tpu_torch.core.gaussians import GaussianParams
from gs_tpu_torch.models import gaussian_model as tgm
from gs_tpu_torch.train.step import apply_exposure, mask_sh_rest

from utils import default_camera, random_params

C = 40


def _params(seed):
    p = random_params(np.random.default_rng(seed), C)
    return {k: np.asarray(getattr(p, k)) for k in GaussianParams._fields}


def _jparams(arrays):
    return JGaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _close(got, ref, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-12, err_msg=what)


def _states(seed=0):
    arrays = _params(seed)
    alive = np.arange(C) < C - 5
    js = jgm.init_state(_jparams(arrays), jnp.asarray(alive), num_images=2)
    ts = tgm.init_state(params_from_numpy(arrays, "cpu"), torch.tensor(alive),
                        num_images=2)
    return js, ts


def test_init_state_and_round_trip():
    js, ts = _states()
    d = state_to_numpy(ts)
    for k, v in js._asdict().items():
        if k in ("params", "m", "v"):
            for f, x in v._asdict().items():
                np.testing.assert_array_equal(d[k][f], np.asarray(x))
        else:
            np.testing.assert_array_equal(d[k], np.asarray(v), err_msg=k)
            assert d[k].dtype == np.asarray(v).dtype, k
    back = state_from_numpy(d, "cpu")
    for a, b in zip(back, ts):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_adam_matches_jax(sparse):
    js, ts = _states()
    rng = np.random.default_rng(1)
    jopt, topt = JOptimizationConfig(), OptimizationConfig()
    for it in (1, 2, 3):
        grads = {k: rng.normal(0, 1e-3, v.shape).astype(np.float32)
                 for k, v in _params(0).items()}
        grads["sh_dc"][::7] = 0.0          # zero gradients: the sign-flip case
        vis = rng.uniform(size=C) < 0.7
        jl = jgm.group_lrs(jopt, jnp.int32(it), 2.0)
        tl = tgm.group_lrs(topt, it, 2.0)
        for k in GaussianParams._fields:
            assert getattr(tl, k) == pytest.approx(float(getattr(jl, k)),
                                                   rel=1e-6)
        js = jgm.adam_update(js, _jparams(grads), jl,
                             jnp.asarray(vis) if sparse else None)
        ts = tgm.adam_update(ts, params_from_numpy(grads, "cpu"), tl,
                             torch.tensor(vis) if sparse else None)
    assert int(ts.step) == int(js.step) == 3
    for group in ("params", "m", "v"):
        for k in GaussianParams._fields:
            _close(getattr(getattr(ts, group), k),
                   getattr(getattr(js, group), k), f"{group}.{k}")


def test_exposure_update_matches_jax():
    js, ts = _states()
    rng = np.random.default_rng(2)
    jopt, topt = JOptimizationConfig(), OptimizationConfig()
    for it in (1, 2):
        g = rng.normal(0, 1e-2, (2, 3, 4)).astype(np.float32)
        js = jgm.exposure_update(js, jnp.asarray(g), jopt, jnp.int32(it))
        ts = tgm.exposure_update(ts, torch.tensor(g), topt, it)
    for k in ("exposure", "exp_m", "exp_v"):
        _close(getattr(ts, k), getattr(js, k), k)
    assert int(ts.exp_step) == int(js.exp_step) == 2


def test_densification_stats_match_jax():
    js, ts = _states()
    rng = np.random.default_rng(3)
    for _ in range(2):
        g = rng.normal(0, 1e-4, (C, 2)).astype(np.float32)
        vis = rng.uniform(size=C) < 0.6
        radii = rng.integers(0, 30, C).astype(np.int32)
        js = jgm.add_densification_stats(js, jnp.asarray(g), jnp.asarray(vis),
                                         64, 48, jnp.asarray(radii))
        ts = tgm.add_densification_stats(ts, torch.tensor(g), torch.tensor(vis),
                                         64, 48, torch.tensor(radii))
    _close(ts.grad_accum, js.grad_accum, "grad_accum")
    np.testing.assert_array_equal(ts.denom.numpy(), np.asarray(js.denom))
    np.testing.assert_array_equal(ts.max_radii2D.numpy(),
                                  np.asarray(js.max_radii2D))


@pytest.mark.parametrize("degree", [0, 1, 2, 3])
def test_sh_mask_and_exposure_match_jax(degree):
    arrays = _params(4)
    got = mask_sh_rest(params_from_numpy(arrays, "cpu"), degree).sh_rest
    ref = jax_mask_sh_rest(_jparams(arrays), jnp.int32(degree)).sh_rest
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    rng = np.random.default_rng(degree)
    img = rng.uniform(0, 1, (3, 8, 6)).astype(np.float32)
    e = (np.eye(3, 4) + rng.normal(0, 0.1, (3, 4))).astype(np.float32)
    _close(apply_exposure(torch.tensor(img), torch.tensor(e)),
           jax_apply_exposure(jnp.asarray(img), jnp.asarray(e)), "exposure")


def test_camera_batch_selects_like_jax():
    cams = [default_camera(32, 24), default_camera(32, 24, fov_deg=50.0)]
    fields = ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy")
    tb = stack_cameras([camera_from_numpy(
        {k: np.asarray(getattr(c, k)) for k in fields}, 32, 24, "cpu")
        for c in cams])
    jb = jax_stack_cameras(cams)
    assert len(tb) == len(jb) == 2
    for i in range(2):
        a, b = tb.select(i), jb.select(i)
        assert (a.width, a.height) == (b.width, b.height)
        for k in fields:
            np.testing.assert_array_equal(getattr(a, k).numpy(),
                                          np.asarray(getattr(b, k)))
    with pytest.raises(ValueError):
        stack_cameras([tb.select(0), camera_from_numpy(
            {k: np.asarray(getattr(cams[0], k)) for k in fields}, 16, 24,
            "cpu")])
