"""gs_tpu_torch.parallel.render_mc.render_multichip against gs_tpu's, and the
banded binning and raster twins against gs_tpu's binned path, on the CPU.

The JAX side runs on the 8 virtual CPU devices of tests/conftest.py
(``make_mesh(k)``, backend "binned"); the port runs ``LocalGroup(k)`` on
the CPU, where every kernel wrapper takes its plain version. The scene is
tests/test_multichip.py's: 256 Gaussians at SH degree 2, 200 alive, a
64x48 view. For k in {2, 4, 8} and the three band assignments ("stride",
"cost", "cost" with two split rows), the frame (image, invdepth, final_T)
agrees within 2e-5 absolute, and the gradients of an L1 + invdepth loss
with respect to every parameter and the mean2d tap within 2e-4 x their
largest magnitude (the rules of tests/test_golden.py). The per-band
duplicate and work counts are equal: both packages deal the same rows.
"""
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
from gs_tpu.core.project import preprocess as jax_preprocess
from gs_tpu.ops.binning import bin_gaussians as jax_bin_gaussians
from gs_tpu.ops.rasterize_jnp import rasterize_binned as jax_rasterize_binned
from gs_tpu.parallel.mesh import gauss_sharding, make_mesh
from gs_tpu.parallel.render_mc import render_multichip as jax_render_mc

from gs_tpu_torch.convert import params_from_numpy
from gs_tpu_torch.core.camera import focal2fov, make_camera
from gs_tpu_torch.core.gaussians import GaussianParams
from gs_tpu_torch.core.project import Projected, preprocess
from gs_tpu_torch.ops import rasterize as trast
from gs_tpu_torch.ops.binning import bin_gaussians, bin_gaussians_payload
from gs_tpu_torch.ops.rasterize_plain import pack_projected, rasterize_binned
from gs_tpu_torch.parallel.mesh import LocalGroup
from gs_tpu_torch.parallel.render_mc import (_cumown, band_layout,
                                             render_multichip)
from gs_tpu_torch.render import render_projected

from utils import default_camera, random_params

W, H = 64, 48
N = 256
KW = dict(dup_capacity=1 << 13, max_per_tile=256, chunk=64)
ASSIGNS = {"stride": dict(band_assign="stride"),
           "cost": dict(band_assign="cost"),
           "split": dict(band_assign="cost", split_rows=2)}
FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene():
    rng = np.random.default_rng(9)
    jparams = random_params(rng, N, sh_degree=2, spread=1.5)
    arrays = {k: np.asarray(getattr(jparams, k)) for k in FIELDS}
    gt = np.random.default_rng(1).uniform(0, 1, (3, H, W)).astype(np.float32)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    return arrays, gt, bg


def port_camera(device="cpu"):
    fovx = math.radians(60.0)
    return make_camera(np.eye(3), np.zeros(3), fovx,
                       focal2fov(W / (2 * math.tan(fovx / 2)), H), W, H,
                       device=device)


def _loss(image, invdepth, gt):
    return abs(image - gt).mean() + 0.1 * invdepth.mean()


def jax_run(scene, k, alive, assign, vcap=0):
    """gs_tpu's render_multichip on make_mesh(k): (output, loss, gradients
    of every parameter and of the tap), as numpy."""
    arrays, gt, bg = scene
    mesh = make_mesh(k)
    sh = gauss_sharding(mesh)
    params = jax.device_put(JGaussianParams(
        **{f: jnp.asarray(v) for f, v in arrays.items()}), sh)
    tap = jax.device_put(jnp.zeros((N, 2), jnp.float32), sh)
    cam = default_camera(W, H)
    jalive = jnp.asarray(alive)

    def f(p, t):
        o = jax_render_mc(p, cam, jnp.asarray(bg), mesh, active_sh_degree=2,
                          alive=jalive, mean2d_tap=t, backend="binned",
                          visible_capacity=vcap, **KW, **ASSIGNS[assign])
        return _loss(o.image, o.invdepth, jnp.asarray(gt)), o

    (loss, out), (gp, gt_) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(params, tap)
    grads = {k_: np.asarray(getattr(gp, k_)) for k_ in FIELDS}
    grads["tap"] = np.asarray(gt_)
    return jax.tree.map(np.asarray, out), float(loss), grads


def port_run(scene, k, alive, assign, vcap=0):
    arrays, gt, bg = scene
    leaves = [t.requires_grad_(True) for t in
              params_from_numpy(arrays, "cpu")]
    tap = torch.zeros((N, 2), requires_grad=True)
    out = render_multichip(
        GaussianParams(*leaves), port_camera(), torch.tensor(bg),
        LocalGroup(k, "cpu"), active_sh_degree=2,
        alive=torch.tensor(alive), mean2d_tap=tap, visible_capacity=vcap,
        **KW, **ASSIGNS[assign])
    loss = _loss(out.image, out.invdepth, torch.tensor(gt))
    g = torch.autograd.grad(loss, leaves + [tap])
    grads = {f: x.numpy() for f, x in zip(FIELDS + ("tap",), g)}
    return out, float(loss.detach()), grads


def assert_frames_match(out, ref, atol=2e-5):
    for name in ("image", "invdepth", "final_T"):
        got = getattr(out, name).detach().numpy()
        want = np.asarray(getattr(ref, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=name)


def assert_grads_match(got, ref, rel=2e-4):
    for name, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got[name] - want).max())
        assert err <= rel * scale, (name, err, scale)


@pytest.mark.parametrize("assign", list(ASSIGNS))
@pytest.mark.parametrize("k", [2, 4, 8])
def test_render_multichip_matches_jax(scene, k, assign):
    alive = np.arange(N) < 200
    ref, ref_loss, ref_grads = jax_run(scene, k, alive, assign)
    out, loss, grads = port_run(scene, k, alive, assign)
    assert not bool(out.overflow) and not bool(ref.overflow)
    assert_frames_match(out, ref)
    np.testing.assert_array_equal(out.radii.numpy(), ref.radii)
    np.testing.assert_array_equal(out.visibility.numpy(), ref.visibility)
    for name in ("band_duplicates", "band_visible", "band_work"):
        np.testing.assert_array_equal(getattr(out, name).numpy(),
                                      getattr(ref, name), err_msg=name)
    assert int(out.num_duplicates) == int(ref.num_duplicates)
    assert int(out.max_tile_len) == int(ref.max_tile_len)
    assert math.isclose(loss, ref_loss, rel_tol=1e-5)
    assert_grads_match(grads, ref_grads)
    assert np.abs(grads["tap"]).max() > 0


def _half_alive():
    return np.random.default_rng(4).uniform(size=N) < 0.5


@pytest.mark.parametrize("k", [2, 4])
def test_visible_capacity_compaction_matches_jax(scene, k):
    """A cap at the largest shard's alive count keeps every visible row:
    the frame and the gradients are the full gather's and JAX's."""
    alive = _half_alive()
    vcap = int(alive.reshape(k, -1).sum(1).max())
    assert vcap < N // k
    ref, _, ref_grads = jax_run(scene, k, alive, "cost", vcap)
    out, _, grads = port_run(scene, k, alive, "cost", vcap)
    full, _, _ = port_run(scene, k, alive, "cost", 0)
    assert not bool(out.overflow) and not bool(ref.overflow)
    assert_frames_match(out, ref)
    for name in ("image", "invdepth", "final_T"):
        assert torch.equal(getattr(out, name), getattr(full, name)), name
    assert_grads_match(grads, ref_grads)
    assert (grads["xyz"][~alive] == 0).all()


def test_visible_capacity_overflow_flag(scene):
    """A shard with more visible Gaussians than the cap raises overflow,
    as in JAX, and reports every shard's visible count."""
    alive = _half_alive()
    ref, _, _ = jax_run(scene, 4, alive, "stride", 8)
    out, _, _ = port_run(scene, 4, alive, "stride", 8)
    assert bool(out.overflow) and bool(ref.overflow)
    np.testing.assert_array_equal(out.band_visible.numpy(), ref.band_visible)
    assert int(out.band_visible.max()) > 8


# ------------------------------------------------ banded binning and raster

def _band_rows(kind):
    """(gs_tpu's binning/render kwargs, the port's, local tile rows): one
    band of each assignment over the 4 global tile rows of a 64x48 frame
    padded to 4. gs_tpu's "stride" band (phase 1, stride 2) is the port's
    row map [1, 3]."""
    rows = np.array([1, 3] if kind == "stride" else [0, 2, 3], np.int32)
    cum = np.concatenate([[0], np.cumsum(np.isin(np.arange(4), rows))])
    kw = dict(row_map=rows, row_cumown=cum.astype(np.int32))
    if kind == "split":
        kw.update(col0_map=np.array([0, 1, 0], np.int32),
                  col1_map=np.array([4, 3, 4], np.int32))
    jkw = dict(row_phase=1, row_stride=2) if kind == "stride" else kw
    return jkw, kw, len(rows)


def _jax_kw(kw):
    return {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


def _port_kw(kw):
    return {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v)
            for k, v in kw.items()}


@pytest.mark.parametrize("kind", ["stride", "cost", "split"])
def test_band_binning_and_raster_twins_match_jax(scene, kind):
    """One band's binning equals gs_tpu's (ranges, gids, validity, counts);
    its render through the kernel path's plain twins (K2, K1g, K3, K4 on
    CPU tensors) and through the plain binned renderer equals gs_tpu's
    rasterize_binned with the same row map, values and gradients."""
    arrays, gt, bg = scene
    jax_kw, kw, rows = _band_rows(kind)
    bh = rows * 16
    cam = default_camera(W, H)
    jp = JGaussianParams(**{f: jnp.asarray(v) for f, v in arrays.items()})
    jproj = jax_preprocess(jp, cam, active_sh_degree=2)
    jbins = jax_bin_gaussians(jproj, W, bh, 16, 16, 1 << 13, **_jax_kw(jax_kw))
    jkw = {k: v for k, v in _jax_kw(jax_kw).items() if k in
           ("row_phase", "row_stride", "row_map")}
    gt_band = jnp.asarray(np.random.default_rng(2).uniform(
        0, 1, (3, bh, W)).astype(np.float32))

    def jloss(mean2d, conic, opacity, rgb):
        pr = jproj._replace(mean2d=mean2d, conic=conic, opacity=opacity,
                            rgb=rgb)
        img, invd, fT = jax_rasterize_binned(pr, jbins, W, bh, jnp.asarray(bg),
                                             max_per_tile=256, chunk=64, **jkw)
        return jnp.abs(img - gt_band).mean() + 0.1 * invd.mean(), (img, fT)

    fields = ("mean2d", "conic", "opacity", "rgb")
    (_, (jimg, jfT)), jgrads = jax.value_and_grad(
        jloss, argnums=(0, 1, 2, 3), has_aux=True)(
        *[getattr(jproj, f) for f in fields])

    proj = preprocess(params_from_numpy(arrays, "cpu"), port_camera(),
                      active_sh_degree=2)
    pkw = _port_kw(kw)
    bins = bin_gaussians(proj, W, bh, 16, 16, 1 << 13, **pkw)
    for name in ("tile_start", "tile_end", "entry_gid", "entry_valid",
                 "num_duplicates", "num_valid", "gauss_counts"):
        np.testing.assert_array_equal(getattr(bins, name).numpy(),
                                      np.asarray(getattr(jbins, name)),
                                      err_msg=name)
    if kind == "split":
        assert int(bins.num_valid) < int(bins.num_duplicates)

    leaves = {f: getattr(proj, f).detach().clone().requires_grad_(True)
              for f in fields}
    pr = proj._replace(**leaves)
    gt_t = torch.tensor(np.asarray(gt_band))
    for backend in ("cuda", "binned"):
        out = render_projected(pr, W, bh, torch.tensor(bg), backend=backend,
                               **KW, **pkw)
        np.testing.assert_allclose(out.image.detach().numpy(),
                                   np.asarray(jimg), atol=2e-5, rtol=0)
        np.testing.assert_allclose(out.final_T.detach().numpy(),
                                   np.asarray(jfT), atol=2e-5, rtol=0)
        loss = (out.image - gt_t).abs().mean() + 0.1 * out.invdepth.mean()
        g = torch.autograd.grad(loss, [leaves[f] for f in fields])
        assert_grads_match({f: x.numpy() for f, x in zip(fields, g)},
                           {f: np.asarray(x) for f, x in zip(fields, jgrads)})


def test_identity_row_map_is_the_full_frame(scene):
    """The kernels' plain versions with the identity row map give, bit for
    bit, what they give with none (a full frame)."""
    arrays, _, _ = scene
    proj = preprocess(params_from_numpy(arrays, "cpu"), port_camera(),
                      active_sh_degree=2)
    bins, feats, plan = bin_gaussians_payload(
        proj, pack_projected(proj), W, H, 16, 16, 1 << 13, exact_cull=True,
        fold_plan=True)
    args = (feats, bins.tile_start, bins.tile_end, 4, trast.max_chunks_for(256))
    ident = torch.arange(3, dtype=torch.int32)
    out0, last0 = trast.raster_tiles_fwd_save(*args)
    out1, last1 = trast.raster_tiles_fwd_save(*args, row_map=ident)
    assert torch.equal(out0, out1) and torch.equal(last0, last1)
    assert torch.equal(trast.raster_tiles_fwd(*args, row_map=ident), out0)
    dout = torch.tensor(np.random.default_rng(3).normal(
        size=out0.shape).astype(np.float32))
    g0 = trast.raster_tiles_bwd(*args, out0, last0, dout, plan.dest)
    g1 = trast.raster_tiles_bwd(*args, out0, last0, dout, plan.dest,
                                row_map=ident)
    assert torch.equal(g0, g1)


def test_band_layout_and_assignment_arithmetic():
    """The padded row counts of gs_tpu/parallel/render_mc.py:259-270 and a
    band's owned-row prefix."""
    assert band_layout(64, 48, 2, "stride") == (4, 3, 4, 2, 0)
    assert band_layout(64, 48, 4, "cost", 2) == (4, 3, 6, 3, 2)
    assert band_layout(1920, 1080, 4, "cost", 2) == (120, 68, 70, 19, 2)
    assert band_layout(1920, 1080, 4, "cost") == (120, 68, 68, 17, 0)
    cum = _cumown(torch.tensor([1, 4, 5]), 6)
    assert cum.tolist() == [0, 0, 1, 1, 1, 2, 3]
    with pytest.raises(ValueError, match="band_assign"):
        band_layout(64, 48, 2, "rows")


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stride", "cost", "split"])
def test_cuda_banded_kernels_match_plain(scene, cuda_device, kind):
    """K1, K1g and K3 of one band against their plain versions on the card,
    under the rules of tests/test_torch_render.py and test_torch_raster_bwd.py."""
    arrays, _, _ = scene
    _, kw, rows = _band_rows(kind)
    proj = preprocess(params_from_numpy(arrays, cuda_device),
                      port_camera(cuda_device), active_sh_degree=2)
    pkw = {k: (v.to(cuda_device) if torch.is_tensor(v) else v)
           for k, v in _port_kw(kw).items()}
    bins, feats, plan = bin_gaussians_payload(
        proj, pack_projected(proj), W, rows * 16, 16, 16, 1 << 13,
        exact_cull=True, fold_plan=True, **pkw)
    kmap = trast.kernel_row_map(pkw["row_map"], cuda_device)
    args = (feats, bins.tile_start, bins.tile_end, 4, trast.max_chunks_for(256))
    out, last = trast.raster_tiles_fwd_save(*args, row_map=kmap)
    torch.cuda.synchronize()
    ref, ref_last = trast.raster_tiles_fwd_plain(*args, save=True,
                                                 row_map=kmap)
    assert torch.equal(trast.raster_tiles_fwd(*args, row_map=kmap), out)
    diff = (out - ref).abs()
    assert float(diff.max()) < 2e-2 and float((diff > 1e-5).float().mean()) < 2e-3
    dout = torch.randn(out.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(0))
    got = trast.raster_tiles_bwd(*args, out, last, dout, plan.dest,
                                 row_map=kmap)
    want = trast.raster_tiles_bwd_plain(*args, out, last, dout, plan.dest,
                                        row_map=kmap)
    scale = want.abs().amax(0).clamp_min(1e-30)
    assert float(((got - want).abs().amax(0) / scale).max()) <= 2e-4


@pytest.mark.cuda
def test_cuda_identity_row_map_is_the_full_frame(scene, cuda_device):
    """On the card, K1, K1g and K3 with the identity row map give bit for
    bit what they give with none."""
    arrays, _, _ = scene
    proj = preprocess(params_from_numpy(arrays, cuda_device),
                      port_camera(cuda_device), active_sh_degree=2)
    bins, feats, plan = bin_gaussians_payload(
        proj, pack_projected(proj), W, H, 16, 16, 1 << 13, exact_cull=True,
        fold_plan=True)
    args = (feats, bins.tile_start, bins.tile_end, 4, trast.max_chunks_for(256))
    ident = torch.arange(3, dtype=torch.int32, device=cuda_device)
    out0, last0 = trast.raster_tiles_fwd_save(*args)
    out1, last1 = trast.raster_tiles_fwd_save(*args, row_map=ident)
    assert torch.equal(out0, out1) and torch.equal(last0, last1)
    assert torch.equal(trast.raster_tiles_fwd(*args, row_map=ident),
                       trast.raster_tiles_fwd(*args))
    dout = torch.randn(out0.shape, device=cuda_device,
                       generator=torch.Generator(cuda_device).manual_seed(1))
    assert torch.equal(
        trast.raster_tiles_bwd(*args, out0, last0, dout, plan.dest),
        trast.raster_tiles_bwd(*args, out0, last0, dout, plan.dest,
                               row_map=ident))


# ------------------------------------------------------- the packed layout

@pytest.mark.parametrize("k", [2, 4])
def test_render_multichip_packed_matches_jax(scene, k):
    """``packed_sh_degree``: the [R, C] block of the scene, its columns
    sharded (JAX: P(None, 'gauss') on make_mesh(k); the port: LocalGroup(k)
    column slices), against JAX's packed multi-chip render by the rules
    above, the block's gradient row for row; and the port's packed frame
    is its tree frame."""
    from jax.sharding import NamedSharding, PartitionSpec as P
    from gs_tpu.core.packed import pack_params as jax_pack_params
    from gs_tpu.parallel.mesh import GAUSS_AXIS
    from gs_tpu_torch.core.packed import pack_params

    arrays, gt, bg = scene
    alive = np.arange(N) < 200
    mesh = make_mesh(k)
    jblock = jax.device_put(
        jax_pack_params(JGaussianParams(
            **{f: jnp.asarray(v) for f, v in arrays.items()})),
        NamedSharding(mesh, P(None, GAUSS_AXIS)))
    tap0 = jax.device_put(jnp.zeros((N, 2), jnp.float32),
                          gauss_sharding(mesh))
    cam = default_camera(W, H)

    def f(p, t):
        o = jax_render_mc(p, cam, jnp.asarray(bg), mesh, active_sh_degree=2,
                          alive=jnp.asarray(alive), mean2d_tap=t,
                          backend="binned", packed_sh_degree=2, **KW,
                          **ASSIGNS["cost"])
        return _loss(o.image, o.invdepth, jnp.asarray(gt)), o

    (ref_loss, ref), (jgb, jgt) = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True))(jblock, tap0)

    block = pack_params(params_from_numpy(arrays, "cpu")).requires_grad_()
    tap = torch.zeros((N, 2), requires_grad=True)
    out = render_multichip(block, port_camera(), torch.tensor(bg),
                           LocalGroup(k, "cpu"), active_sh_degree=2,
                           alive=torch.tensor(alive), mean2d_tap=tap,
                           packed_sh_degree=2, **KW, **ASSIGNS["cost"])
    loss = _loss(out.image, out.invdepth, torch.tensor(gt))
    gb, gtap = torch.autograd.grad(loss, [block, tap])
    assert not bool(out.overflow) and not bool(ref.overflow)
    assert_frames_match(out, jax.tree.map(np.asarray, ref))
    assert math.isclose(float(loss), float(ref_loss), rel_tol=1e-5)
    assert_grads_match({"block": gb.numpy(), "tap": gtap.numpy()},
                       {"block": np.asarray(jgb), "tap": np.asarray(jgt)})
    tree, _, _ = port_run(scene, k, alive, "cost")
    for name in ("image", "invdepth", "final_T"):
        assert torch.equal(getattr(out, name), getattr(tree, name)), name
