"""gs_tpu_torch binning (ops/binning.py) against
gs_tpu.ops.binning.bin_gaussians_payload with the Pallas expansion in
interpret mode: every TileBins integer field exact, the sorted payload rows
equal. Both sides bin the same projected scene (the JAX preprocess output,
carried across as numpy), so the comparison isolates binning."""
import numpy as np
import pytest
import torch

from gs_tpu.core.project import preprocess
from gs_tpu.ops.binning import bin_gaussians_payload as jax_bin
from gs_tpu.ops.rasterize_jnp import pack_projected as jax_pack
from gs_tpu_torch.core.project import Projected
from gs_tpu_torch.ops import binning as tbin
from gs_tpu_torch.ops.rasterize_plain import pack_projected

from utils import default_camera, random_params


def _scene(seed=7, n=300, width=96, height=64):
    params = random_params(np.random.default_rng(seed), n)
    cam = default_camera(width, height)
    alive = np.arange(n) < n - 20
    return preprocess(params, cam, active_sh_degree=1, alive=alive), cam


def _to_torch(proj):
    return Projected(*[torch.from_numpy(np.array(x)) for x in proj])


@pytest.mark.parametrize("exact_cull,capacity", [
    (True, 4096), (False, 4096), (True, 1024)],
    ids=["exact-cull", "no-cull", "overflow"])
def test_bins_match_jax(exact_cull, capacity):
    proj, cam = _scene()
    payload = jax_pack(proj)
    jb, jcols = jax_bin(proj, payload, cam.width, cam.height, 16, 16, capacity,
                        expand="pallas", expand_interpret=True,
                        exact_cull=exact_cull)
    tproj = _to_torch(proj)
    tb, tcols = tbin.bin_gaussians_payload(
        tproj, pack_projected(tproj), cam.width, cam.height, 16, 16, capacity,
        exact_cull=exact_cull)
    assert bool(tb.overflow) == bool(jb.overflow) == (capacity == 1024)
    for k in ("entry_gid", "entry_valid", "tile_start", "tile_end",
              "num_duplicates", "gauss_counts", "num_valid"):
        a, b = np.asarray(getattr(jb, k)), getattr(tb, k).numpy()
        assert a.dtype == b.dtype, (k, a.dtype, b.dtype)
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert tcols.shape == (10, capacity)
    np.testing.assert_array_equal(tcols.numpy(), np.stack(jcols))


def test_bin_gaussians_without_payload():
    proj, cam = _scene(seed=8)
    jb, _ = jax_bin(proj, None, cam.width, cam.height, 16, 16, 4096)
    tb = tbin.bin_gaussians(_to_torch(proj), cam.width, cam.height, 16, 16, 4096)
    for k in ("entry_gid", "tile_start", "tile_end", "num_duplicates",
              "gauss_counts"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(),
                                      np.asarray(getattr(jb, k)), err_msg=k)


def test_binning_rejects_capacity_past_f32_exact_range():
    proj, cam = _scene()
    with pytest.raises(ValueError):
        tbin.bin_gaussians(_to_torch(proj), cam.width, cam.height, 16, 16,
                           1 << 24)
