"""gs_tpu_torch.render against the JAX package's Pallas render (interpret
mode, expansion kernel on, no-grad): image, invdepth, final_T, the binning
diagnostics and the overflow flag at a dup_capacity that fits and at one
that does not."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gs_tpu.render import render as jax_render
from gs_tpu_torch.render import render

from test_torch_render import small_scene


@pytest.mark.parametrize("dup_capacity", [1 << 14, 512], ids=["fits", "overflow"])
def test_matches_jax_pallas_render(dup_capacity):
    params, cam, tparams, tcam = small_scene()
    bg = np.array([0.2, 0.5, 0.8], np.float32)
    kw = dict(active_sh_degree=2, dup_capacity=dup_capacity, max_per_tile=256,
              exact_cull=True)
    a = jax_render(cam, params, jnp.asarray(bg), backend="pallas_interpret",
                   fwd_only=True, pallas_expand=True, **kw)
    b = render(tcam, tparams, torch.from_numpy(bg), backend="cuda", **kw)
    assert bool(b.overflow) == bool(a.overflow) == (dup_capacity == 512)
    for k in ("num_duplicates", "max_tile_len", "num_valid"):
        assert int(getattr(b, k)) == int(getattr(a, k)), k
    np.testing.assert_array_equal(b.radii.numpy(), np.asarray(a.radii))
    if not bool(a.overflow):
        for k in ("image", "invdepth", "final_T"):
            np.testing.assert_allclose(getattr(b, k).numpy(),
                                       np.asarray(getattr(a, k)),
                                       atol=2e-5, rtol=0, err_msg=k)
