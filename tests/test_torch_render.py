"""gs_tpu_torch.render on the CPU: the committed golden renders and
parameter gradients, the reference's pipeline switches against gs_tpu, and
gradients through every backend. On a card, kernel K1 against its plain
version, on a render and on the adversarial scenes of
test_torch_raster_cull.py. The comparison with the JAX Pallas render is in
test_torch_render_pallas.py."""
import math
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from gs_tpu.render import render as jax_render
from gs_tpu_torch.convert import camera_from_numpy, params_from_numpy
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.ops import rasterize as trast
from gs_tpu_torch.ops.binning import bin_gaussians_payload, tile_grid
from gs_tpu_torch.ops.rasterize_plain import pack_projected
from gs_tpu_torch.core.project import preprocess
from gs_tpu_torch.render import render

from utils import default_camera, random_params
from test_torch_raster_cull import SCENES, scene_tensors

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "golden_small.npz")
FIELDS = ("xyz", "sh_dc", "sh_rest", "log_scale", "quat", "logit_opacity")


def assert_images_match(x, y, boundary_frac=2e-3, boundary_atol=2e-2, atol=1e-5):
    """The rule tests/test_rasterize.py::assert_images_match holds the JAX
    backends to: the T < 1e-4 cut can flip on float-associativity
    differences, so a tiny fraction of values may differ. (Copied, not
    imported: that module imports ``tests.utils``, which does not resolve
    in every environment the card tests run in.)"""
    diff = np.abs(np.asarray(x) - np.asarray(y))
    assert diff.max() < boundary_atol, f"max diff {diff.max()}"
    frac_bad = (diff > atol).mean()
    assert frac_bad < boundary_frac, f"{frac_bad:.4%} pixels beyond {atol}"


def _golden_cameras(device, W=128, H=96):
    """The two cameras of tests/golden/gen_golden.py, built by the port."""
    fovx = math.radians(60.0)
    fovy = focal2fov(W / (2 * math.tan(fovx / 2)), H)
    ang = math.radians(8.0)
    R = np.array([[math.cos(ang), 0, math.sin(ang)],
                  [0, 1, 0],
                  [-math.sin(ang), 0, math.cos(ang)]])
    return [make_camera(np.eye(3), np.zeros(3), fovx, fovy, W, H, device=device),
            make_camera(R, np.array([0.3, -0.1, 0.2]), fovx, fovy, W, H,
                        device=device)]


@pytest.mark.parametrize("backend", ["cuda", "binned", "depthwise"])
@pytest.mark.parametrize("ci", [0, 1])
def test_golden_values(backend, ci):
    """Values at 2e-5 and the loss's parameter gradients at 2e-4 * max, the
    rules of tests/test_golden.py:67-81, without running JAX."""
    data = np.load(GOLDEN)
    params = params_from_numpy({k: data[f"p_{k}"] for k in FIELDS}, "cpu")
    params = type(params)(*[t.requires_grad_(True) for t in params])
    cam = _golden_cameras("cpu")[ci]
    bg = torch.zeros(3) if ci == 0 else torch.ones(3)
    out = render(cam, params, bg, active_sh_degree=3, backend=backend,
                 antialiasing=(ci == 1), dup_capacity=1 << 13,
                 max_per_tile=512, exact_cull=True)
    assert not bool(out.overflow)
    for k, ref in (("image", "img"), ("invdepth", "invd"), ("final_T", "finalT")):
        np.testing.assert_allclose(getattr(out, k).detach().numpy(),
                                   data[f"{ref}_{ci}"], atol=2e-5, rtol=0,
                                   err_msg=k)
    loss = (out.image - 0.5).abs().mean() + 0.1 * out.invdepth.mean()
    np.testing.assert_allclose(float(loss.detach()), float(data[f"loss_{ci}"]),
                               atol=1e-6)
    grads = torch.autograd.grad(loss, list(params))
    for k, g in zip(FIELDS, grads):
        ref = data[f"g{ci}_{k}"]
        scale = max(np.abs(ref).max(), 1e-3)
        np.testing.assert_allclose(g.numpy(), ref, atol=2e-4 * scale, rtol=0,
                                   err_msg=f"gradient of {k}")


def small_scene():
    params = random_params(np.random.default_rng(5), 300, sh_degree=2)
    cam = default_camera(64, 48)
    tparams = params_from_numpy({k: np.asarray(getattr(params, k))
                                 for k in FIELDS}, "cpu")
    tcam = camera_from_numpy({k: np.asarray(getattr(cam, k)) for k in
                              ("world_view", "full_proj", "camera_center",
                               "tan_fovx", "tan_fovy")}, 64, 48, "cpu")
    return params, cam, tparams, tcam


@pytest.mark.parametrize("flags", [
    dict(convert_SHs_python=True), dict(compute_cov3D_python=True),
    dict(scaling_modifier=0.7, antialiasing=True)],
    ids=["shs-python", "cov3d-python", "scale-aa"])
def test_pipeline_switches_match_jax(flags):
    params, cam, tparams, tcam = small_scene()
    kw = dict(active_sh_degree=2, backend="binned", dup_capacity=1 << 14,
              max_per_tile=256, **flags)
    a = jax_render(cam, params, jnp.zeros(3), **kw)
    b = render(tcam, tparams, torch.zeros(3), **kw)
    for k in ("image", "invdepth", "final_T"):
        np.testing.assert_allclose(getattr(b, k).numpy(),
                                   np.asarray(getattr(a, k)),
                                   atol=2e-5, rtol=0, err_msg=k)


@pytest.mark.parametrize("backend", ["cuda", "binned", "depthwise"])
def test_gradients_flow_through_every_backend(backend):
    """Every parameter group and the background get a finite, nonzero
    gradient; on CPU tensors the cuda backend runs the kernels' plain
    versions and launches nothing."""
    from gs_tpu_torch.ops.expand import expand_rows
    from gs_tpu_torch.ops.fold import fold_rows
    counters = (expand_rows, trast.raster_tiles_fwd,
                trast.raster_tiles_fwd_save, trast.raster_tiles_bwd, fold_rows)
    before = [c.launches for c in counters]
    _, _, tparams, tcam = small_scene()
    leaves = [t.clone().requires_grad_(True) for t in tparams]
    bg = torch.tensor([0.2, 0.5, 0.8], requires_grad=True)
    out = render(tcam, type(tparams)(*leaves), bg, active_sh_degree=2,
                 backend=backend, dup_capacity=1 << 14, max_per_tile=256)
    loss = (out.image ** 2).sum() + out.invdepth.sum() + out.final_T.sum()
    grads = torch.autograd.grad(loss, leaves + [bg])
    for name, g in zip(FIELDS + ("bg",), grads):
        assert bool(torch.isfinite(g).all()), name
        assert float(g.abs().max()) > 0, name
    assert [c.launches for c in counters] == before


def test_render_rejects_mixed_devices_and_unknown_backend():
    _, _, tparams, tcam = small_scene()
    with pytest.raises(ValueError):
        render(tcam, tparams, torch.zeros(3, device="meta"), active_sh_degree=2)
    with pytest.raises(ValueError):
        render(tcam, tparams, torch.zeros(3), active_sh_degree=2,
               backend="pallas")


def _kernel_loop_work(feats, tile_start, tile_end, gx, max_chunks):
    """csrc/rasterize_fwd.cu's loop in numpy: each tile's pixels walk its
    entries in order with their own float32 T, and count the pairs by where
    the loop body drops them."""
    f = feats.numpy()
    work = dict(entries=0, **dict.fromkeys(trast.K1_OPS, 0))
    lane = np.arange(256)
    for t, (s, e) in enumerate(zip(tile_start.tolist(), tile_end.tolist())):
        px = ((t % gx) * 16 + lane % 16).astype(np.float32)
        py = ((t // gx) * 16 + lane // 16).astype(np.float32)
        T = np.ones(256, np.float32)
        live = np.ones(256, bool)
        for j in range(s, min(e, s // 128 * 128 + max_chunks * 128)):
            if not live.any():
                break
            x, y, a, b, c, op = f[:6, j]
            dx, dy = x - px, y - py
            power = np.float32(-0.5) * (a * dx * dx + c * dy * dy) - b * dx * dy
            with np.errstate(over="ignore"):
                alpha = np.minimum(np.float32(0.99), op * np.exp(power))
            culled = live & (power > 0)
            faint = live & ~culled & (alpha < np.float32(1 / 255))
            test_t = T * (np.float32(1) - alpha)
            stop = live & ~culled & ~faint & (test_t < np.float32(1e-4))
            comp = live & ~culled & ~faint & ~stop
            work["entries"] += 1
            for k, m in (("culled", culled), ("faint", faint),
                         ("stopping", stop), ("composited", comp)):
                work[k] += int(m.sum())
            T = np.where(comp, test_t, T)
            live &= ~stop
    return work


@pytest.mark.parametrize("opacity_shift", [0.0, 6.0], ids=["sparse", "opaque"])
def test_raster_work_counts_what_the_kernel_loop_does(opacity_shift):
    _, _, tparams, tcam = small_scene()
    tparams = tparams._replace(logit_opacity=tparams.logit_opacity
                               + opacity_shift)
    proj = preprocess(tparams, tcam, active_sh_degree=2)
    bins, feats = bin_gaussians_payload(proj, pack_projected(proj), 64, 48,
                                        16, 16, 1 << 14, exact_cull=True)
    gx, _ = tile_grid(64, 48, 16, 16)
    args = (feats, bins.tile_start, bins.tile_end, gx, trast.max_chunks_for(256))
    work = trast.raster_tiles_fwd_work(*args)
    ref = _kernel_loop_work(*args)
    assert {k: work[k] for k in ref} == ref
    # a conic from the projection is positive definite: power > 0 is a guard
    assert ref["culled"] == 0
    assert ref["faint"] > 0 and ref["composited"] > 0
    assert (ref["stopping"] > 0) == (opacity_shift > 0), ref
    assert work["ops"] == sum(trast.K1_OPS[k] * ref[k] for k in trast.K1_OPS)
    assert work["bytes"] == 4 * (10 * ref["entries"] + 2 * 12 + 12 * 5 * 256)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_raster_matches_plain(cuda_device):
    _, _, tparams, _ = small_scene()
    params = params_from_numpy({k: getattr(tparams, k).numpy() for k in FIELDS},
                               cuda_device)
    cam = _golden_cameras(cuda_device)[0]
    proj = preprocess(params, cam, active_sh_degree=2)
    bins, feats = bin_gaussians_payload(proj, pack_projected(proj), cam.width,
                                        cam.height, 16, 16, 1 << 14,
                                        exact_cull=True)
    gx, _ = tile_grid(cam.width, cam.height, 16, 16)
    args = (feats, bins.tile_start, bins.tile_end, gx, trast.max_chunks_for(512))
    got = trast.raster_tiles_fwd(*args)
    torch.cuda.synchronize()
    ref = trast.raster_tiles_fwd_plain(*args)
    assert_images_match(got.cpu().numpy(), ref.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", SCENES)
def test_cuda_raster_adversarial_scenes(cuda_device, kind):
    args, _ = scene_tensors(kind, cuda_device)
    got = trast.raster_tiles_fwd(*args)
    torch.cuda.synchronize()
    ref = trast.raster_tiles_fwd_plain(*args)
    assert_images_match(got.cpu().numpy(), ref.cpu().numpy())
