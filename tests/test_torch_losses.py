"""The loss primitives and the learning-rate schedule against the JAX
package: SSIM and its gradient (the JAX SSIM is held to the reference's
torch SSIM at 2e-6, tests/test_ssim.py), L1, L2, PSNR, and expon_lr over
its delay, decay and clip ranges."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.ops import losses as jl
from gs_tpu.ops.ssim import ssim as jax_ssim
from gs_tpu.utils.schedules import expon_lr as jax_expon_lr

from gs_tpu_torch.ops import losses as tl
from gs_tpu_torch.ops.ssim import ssim

from test_ssim import torch_reference_ssim


def _pair(seed, shape=(3, 48, 40)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize("seed", [1, 2])
def test_ssim_value_and_gradient_match_jax(seed):
    a, b = _pair(seed)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    ref, jgrad = jax.value_and_grad(jax_ssim)(ja, jb)
    x = torch.tensor(a, requires_grad=True)
    got = ssim(x, torch.tensor(b))
    (grad,) = torch.autograd.grad(got, x)
    assert abs(float(got.detach()) - float(ref)) < 1e-6
    assert abs(float(got.detach()) - torch_reference_ssim(a, b)) < 2e-6
    scale = float(np.abs(np.asarray(jgrad)).max())
    np.testing.assert_allclose(grad.numpy(), np.asarray(jgrad),
                               atol=1e-4 * scale, rtol=0)
    assert float(ssim(torch.tensor(a), torch.tensor(a))) == pytest.approx(
        1.0, abs=1e-6)


def test_pixel_losses_match_jax():
    a, b = _pair(3)
    for name in ("l1_loss", "l2_loss"):
        np.testing.assert_allclose(
            float(getattr(tl, name)(torch.tensor(a), torch.tensor(b))),
            float(getattr(jl, name)(jnp.asarray(a), jnp.asarray(b))),
            rtol=1e-6)
    np.testing.assert_allclose(
        tl.psnr(torch.tensor(a[None]), torch.tensor(b[None])).numpy(),
        np.asarray(jl.psnr(jnp.asarray(a[None]), jnp.asarray(b[None]))),
        rtol=1e-6)


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4, lr_final=1.6e-6, lr_delay_mult=0.01, max_steps=30000),
    dict(lr_init=0.01, lr_final=0.001, lr_delay_steps=500, lr_delay_mult=0.0,
         max_steps=30000),
    dict(lr_init=1.0, lr_final=0.01, max_steps=100),
    dict(lr_init=0.0, lr_final=0.0)])
def test_expon_lr_matches_jax(kw):
    from gs_tpu_torch.utils.schedules import expon_lr
    for step in (-1, 0, 1, 7, 250, 499, 500, 501, 15000, 29999, 30000, 40000):
        got = expon_lr(step, **kw)
        ref = float(jax_expon_lr(step, **kw))
        assert isinstance(got, float)
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-12), step
