"""gs_tpu_torch.train.step against gs_tpu.train.step on the CPU: three
training steps of a 60-Gaussian 64x48 scene from one carried-over state,
the port on its kernel backend (plain versions on the CPU) and on the
binned oracle, the JAX package on its binned backend. The step's options
(sparse Adam, exposure, depth-L1, alpha mask) are in
test_torch_train_options.py.

Tolerances. The step-1 gradients are compared through the first Adam
moment, m_1 = 0.1 g exactly, and the mean2d tap's through its norm in the
densification statistics, at the golden rule 2e-4 * max per field. After
that the states cannot be compared that tightly: Adam's first update is
lr * g / (|g| + 1e-15), nearly lr * sign(g), so a parameter whose gradient
is zero up to rounding moves by +lr in one package and -lr in the other.
For t <= 3, |m_hat / sqrt(v_hat)| <= 1.0014 for any gradient sequence
(Cauchy-Schwarz on the moment sums), so two correct steps move a
parameter at most 2.01 * lr of its group apart per step; the parameters
are held to that, with at most 1 % of each group's values more than
lr / 100 apart (only gradients near zero flip), and the loss of every step
to 1e-5 relative."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.config import (ModelConfig as JModelConfig,
                           OptimizationConfig as JOptimizationConfig,
                           PipelineConfig as JPipelineConfig,
                           RasterConfig as JRasterConfig)
from gs_tpu.core.camera import stack_cameras as jax_stack_cameras
from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
from gs_tpu.models.gaussian_model import TrainState as JTrainState
from gs_tpu.models.gaussian_model import init_state as jax_init_state
from gs_tpu.render import render as jax_render
from gs_tpu.train.step import make_train_step as jax_make_train_step

from gs_tpu_torch.config import (ModelConfig, OptimizationConfig,
                                 PipelineConfig, RasterConfig)
from gs_tpu_torch.convert import (camera_from_numpy, state_from_numpy,
                                  state_to_numpy)
from gs_tpu_torch.core.camera import stack_cameras
from gs_tpu_torch.models.gaussian_model import group_lrs
from gs_tpu_torch.ops.expand import expand_rows
from gs_tpu_torch.ops.fold import fold_rows
from gs_tpu_torch.ops.rasterize import (raster_tiles_bwd, raster_tiles_fwd,
                                        raster_tiles_fwd_save)
from gs_tpu_torch.train.step import make_train_step

from utils import default_camera, random_params

W, H = 64, 48
STEPS = 3
CAM_FIELDS = ("world_view", "full_proj", "camera_center", "tan_fovx",
              "tan_fovy")


def _jax_state(d):
    def gp(x):
        return JGaussianParams(**{k: jnp.asarray(v) for k, v in x.items()})
    return JTrainState(**{k: gp(v) if k in ("params", "m", "v")
                          else jnp.asarray(v) for k, v in d.items()})


def _jax_to_numpy(state):
    return {k: ({f: np.asarray(x) for f, x in v._asdict().items()}
                if k in ("params", "m", "v") else np.asarray(v))
            for k, v in state._asdict().items()}


def make_scene(seed=7):
    """A 60-Gaussian scene in a 64-slot state, the default camera and a
    ground truth rendered from another random scene, for both packages."""
    rng = np.random.default_rng(seed)
    n, cap = 60, 64
    p = random_params(rng, n)
    pad = cap - n

    def padz(x):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1))

    p = jax.tree.map(padz, p)
    p = p._replace(quat=p.quat.at[n:, 0].set(1.0),
                   log_scale=p.log_scale.at[n:].set(-10.0),
                   logit_opacity=p.logit_opacity.at[n:].set(-10.0))
    alive = jnp.arange(cap) < n
    cam = default_camera(W, H)
    gt = jax_render(cam, random_params(rng, 50), jnp.zeros(3),
                    active_sh_degree=3, backend="binned",
                    dup_capacity=1 << 13, max_per_tile=256).image
    state0 = _jax_to_numpy(jax_init_state(p, alive, num_images=1))
    return cam, gt, state0


@pytest.fixture(scope="module")
def scene():
    cam, gt, state0 = make_scene()
    opt = JOptimizationConfig(iterations=100, position_lr_max_steps=100)
    raster = JRasterConfig(backend="binned", dup_capacity=1 << 13,
                           max_per_tile=256, chunk=64)
    step = jax_make_train_step(opt, JModelConfig(), JPipelineConfig(), raster,
                               jax_stack_cameras([cam]), spatial_lr_scale=1.0,
                               max_sh_degree=3)
    st = _jax_state(state0)
    states, losses = [], []
    for it in range(1, STEPS + 1):
        st, m = step(st, jnp.int32(0), gt, None, None, None, jnp.float32(0.0),
                     jnp.int32(it), jax.random.key(it))
        states.append(_jax_to_numpy(st))
        losses.append(float(m.loss))
    return dict(cam={k: np.asarray(getattr(cam, k)) for k in CAM_FIELDS},
                gt=np.asarray(gt), state0=state0, states=states,
                losses=losses)


def _torch_run(scene, backend):
    cams = stack_cameras([camera_from_numpy(scene["cam"], W, H, "cpu")])
    opt = OptimizationConfig(iterations=100, position_lr_max_steps=100)
    raster = RasterConfig(backend=backend, dup_capacity=1 << 13,
                          max_per_tile=256, chunk=64)
    step = make_train_step(opt, ModelConfig(), PipelineConfig(), raster, cams,
                           spatial_lr_scale=1.0, max_sh_degree=3)
    st = state_from_numpy(scene["state0"], "cpu")
    gt = torch.tensor(scene["gt"])
    states, metrics = [], []
    for it in range(1, STEPS + 1):
        st, m = step(st, 0, gt, iteration=it)
        states.append(state_to_numpy(st))
        metrics.append(m)
    return opt, states, metrics


@pytest.mark.parametrize("backend", ["cuda", "binned"])
def test_three_steps_match_jax(scene, backend):
    launches = (expand_rows.launches, raster_tiles_fwd.launches,
                raster_tiles_fwd_save.launches, raster_tiles_bwd.launches,
                fold_rows.launches)
    opt, states, metrics = _torch_run(scene, backend)
    # CPU tensors: every kernel wrapper ran its plain version
    assert (expand_rows.launches, raster_tiles_fwd.launches,
            raster_tiles_fwd_save.launches, raster_tiles_bwd.launches,
            fold_rows.launches) == launches
    for m, ref in zip(metrics, scene["losses"]):
        assert not bool(m.overflow)
        np.testing.assert_allclose(float(m.loss), ref, rtol=1e-5)
    assert metrics[-1].loss < metrics[0].loss

    # step 1: m_1 = 0.1 * grad, held to the golden gradient rule
    for k, ref in scene["states"][0]["m"].items():
        got = states[0]["m"][k]
        scale = max(np.abs(ref).max(), 1e-12)
        np.testing.assert_allclose(got, ref, atol=2e-4 * scale, rtol=0,
                                   err_msg=f"step-1 gradient of {k}")
    # the mean2d tap's step-1 gradient, through its norm in grad_accum
    ref = scene["states"][0]["grad_accum"]
    np.testing.assert_allclose(states[0]["grad_accum"], ref,
                               atol=2e-4 * np.abs(ref).max(), rtol=0)
    end, ref_end = states[-1], scene["states"][-1]
    for k in ("step", "alive", "exposure", "exp_step"):
        np.testing.assert_array_equal(end[k], ref_end[k], err_msg=k)
    np.testing.assert_array_equal(end["max_radii2D"], ref_end["max_radii2D"])
    np.testing.assert_array_equal(end["denom"], ref_end["denom"])
    # steps 2-3 see parameters up to ~lr apart: ten times the rule
    scale = np.abs(ref_end["grad_accum"]).max()
    np.testing.assert_allclose(end["grad_accum"], ref_end["grad_accum"],
                               atol=2e-3 * scale, rtol=0)
    for k, lr in group_lrs(opt, 1, 1.0)._asdict().items():
        bound = 2.01 * STEPS * max(lr, group_lrs(opt, STEPS, 1.0)._asdict()[k])
        diff = np.abs(end["params"][k] - ref_end["params"][k])
        assert diff.max() <= bound, (k, diff.max(), bound)
        assert (diff > 1e-2 * lr).mean() <= 0.01, k
