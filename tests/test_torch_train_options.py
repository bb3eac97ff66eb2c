"""The training step's options against gs_tpu.train.step on the CPU, from
one carried-over state: sparse Adam (only rows visible in the render
move), the per-camera exposure transform and its optimizer, the depth-L1
term, an alpha mask and a white background, two steps on the port's
kernel backend (plain versions on the CPU) against the JAX binned step.
Tolerances as in test_torch_train.py: the step-1 gradients through the
first Adam moments at 2e-4 * max, the losses at 1e-5 relative, and the
parameters within 2.01 * lr of their group per step."""
import numpy as np
import torch

import jax
import jax.numpy as jnp
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.core.camera import stack_cameras as jax_stack_cameras
from gs_tpu.train.step import make_train_step as jax_make_train_step

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import (camera_from_numpy, state_from_numpy,
                                  state_to_numpy)
from gs_tpu_torch.core.camera import stack_cameras
from gs_tpu_torch.models.gaussian_model import group_lrs
from gs_tpu_torch.train.step import make_train_step

from test_torch_train import (CAM_FIELDS, H, W, _jax_state, _jax_to_numpy,
                              make_scene)

STEPS = 2


def test_sparse_adam_exposure_depth_and_mask_match_jax():
    cam, gt, state0 = make_scene(seed=8)
    rng = np.random.default_rng(8)
    invd = rng.uniform(0.1, 0.4, (H, W)).astype(np.float32)
    dmask = (rng.uniform(size=(H, W)) < 0.8).astype(np.float32)
    alpha = (rng.uniform(size=(1, H, W)) < 0.9).astype(np.float32)
    kw = dict(iterations=100, position_lr_max_steps=100,
              optimizer_type="sparse_adam")
    model = dict(train_test_exp=True, white_background=True)

    jstep = jax_make_train_step(
        JOptimizationConfig(**kw), JModelConfig(**model), JPipelineConfig(),
        JRasterConfig(backend="binned", dup_capacity=1 << 13,
                      max_per_tile=256, chunk=64),
        jax_stack_cameras([cam]), spatial_lr_scale=1.0, max_sh_degree=3)
    st = _jax_state(state0)
    ref, ref_losses = [], []
    for it in range(1, STEPS + 1):
        st, m = jstep(st, jnp.int32(0), gt, jnp.asarray(alpha),
                      jnp.asarray(invd), jnp.asarray(dmask), jnp.float32(1.0),
                      jnp.int32(it), jax.random.key(it))
        ref.append(_jax_to_numpy(st))
        ref_losses.append((float(m.loss), float(m.depth_l1)))

    opt = OptimizationConfig(**kw)
    cams = stack_cameras([camera_from_numpy(
        {k: np.asarray(getattr(cam, k)) for k in CAM_FIELDS}, W, H, "cpu")])
    step = make_train_step(opt, ModelConfig(**model), PipelineConfig(),
                           RasterConfig(dup_capacity=1 << 13, max_per_tile=256,
                                        chunk=64), cams, spatial_lr_scale=1.0,
                           max_sh_degree=3)
    ts = state_from_numpy(state0, "cpu")
    got, visible = [], []
    for it in range(1, STEPS + 1):
        ts, m = step(ts, 0, torch.tensor(np.asarray(gt)), torch.tensor(alpha),
                     torch.tensor(invd), torch.tensor(dmask), 1.0,
                     iteration=it)
        got.append(state_to_numpy(ts))
        np.testing.assert_allclose((float(m.loss), float(m.depth_l1)),
                                   ref_losses[it - 1], rtol=1e-5)
        assert float(m.depth_l1) > 0
        visible.append(int(m.n_visible))

    for group in ("m", "v"):
        for k, r in ref[0][group].items():
            np.testing.assert_allclose(got[0][group][k], r,
                                       atol=2e-4 * max(np.abs(r).max(), 1e-30),
                                       rtol=0, err_msg=f"{group}.{k}")
    for k in ("exp_m", "exp_v"):
        r = ref[0][k]
        np.testing.assert_allclose(got[0][k], r, atol=2e-4 * np.abs(r).max(),
                                   rtol=0, err_msg=k)
    lr_exp = 0.01                       # exposure_lr_init, no delay
    assert np.abs(got[-1]["exposure"] - ref[-1]["exposure"]).max() \
        <= 2.01 * STEPS * lr_exp
    assert np.abs(got[-1]["exposure"] - state0["exposure"]).max() > 0
    for k, lr in group_lrs(opt, 1, 1.0)._asdict().items():
        diff = np.abs(got[-1]["params"][k] - ref[-1]["params"][k])
        assert diff.max() <= 2.01 * STEPS * lr, k
    # sparse Adam: rows outside every render (the dead slots) never move
    dead = ~state0["alive"]
    assert visible[0] < len(dead) and dead.any()
    for k, v in got[-1]["params"].items():
        np.testing.assert_array_equal(v[dead], state0["params"][k][dead])
        np.testing.assert_array_equal(got[-1]["m"][k][dead], 0.0)


def test_random_background_comes_from_the_generator():
    """Under ``random_background`` the step draws bg from the generator it
    is given: the same seed gives the same state, and passing that draw as
    ``bg`` gives it too."""
    cam, gt, state0 = make_scene(seed=9)
    cams = stack_cameras([camera_from_numpy(
        {k: np.asarray(getattr(cam, k)) for k in CAM_FIELDS}, W, H, "cpu")])
    step = make_train_step(
        OptimizationConfig(random_background=True), ModelConfig(),
        PipelineConfig(), RasterConfig(dup_capacity=1 << 13, max_per_tile=256),
        cams, spatial_lr_scale=1.0, max_sh_degree=3)
    gt = torch.tensor(np.asarray(gt))

    def run(**kw):
        st, m = step(state_from_numpy(state0, "cpu"), 0, gt, **kw)
        return float(m.loss), state_to_numpy(st)["params"]["xyz"]

    a = run(generator=torch.Generator().manual_seed(3))
    b = run(generator=torch.Generator().manual_seed(3))
    c = run(bg=torch.rand(3, generator=torch.Generator().manual_seed(3)))
    d = run(generator=torch.Generator().manual_seed(4))
    assert a[0] == b[0] == c[0] != d[0]
    np.testing.assert_array_equal(a[1], c[1])
