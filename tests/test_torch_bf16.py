"""bf16 feature streaming of gs_tpu_torch against gs_tpu's on the CPU.

* ``pack_bf16_pair``/``unpack_bf16_pair`` bitwise to JAX's
  (``jax.lax.bitcast_convert_type``) on values with rounding ties, zero high
  halves (pairs whose float32 reading is denormal) and zeros;
* the sorted payload of ``bin_gaussians_payload(bf16_pairs=True)`` bitwise
  to JAX's (its Pallas expansion in interpret mode, which packs after the
  expansion as the port does), also for a scene whose green is exactly 0;
* the port's bf16 render (the ``cuda`` backend's plain versions on CPU
  tensors) against JAX's ``render(backend="pallas_interpret",
  bf16_features=True)`` on a 300-Gaussian 64x48 scene: image, invdepth and
  final_T within 2e-5, gradients within 2e-4 x their largest magnitude (both
  quantise alike, and the backward is straight-through in both); the bf16
  frame within JAX's envelope of the f32 one (1e-2, tests/test_pallas.py);
* ``binned`` ignores the flag in both packages.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from gs_tpu.ops import binning as jbin
from gs_tpu.ops.rasterize_jnp import pack_projected as jax_pack
from gs_tpu.render import render as jax_render

from gs_tpu_torch.convert import params_from_numpy
from gs_tpu_torch.core.gaussians import GaussianParams
from gs_tpu_torch.core.sh import C0
from gs_tpu_torch.ops import binning as tbin
from gs_tpu_torch.ops.rasterize_plain import pack_projected
from gs_tpu_torch.render import render

from test_torch_binning import _to_torch
from test_torch_render import small_scene

FIELDS = GaussianParams._fields


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair_inputs():
    """(a, b) float32 columns: random values, exact bf16 rounding ties (a
    half-way low half, with even and odd kept mantissas), zero high halves
    under nonzero low halves, zeros, signs and extremes."""
    rng = np.random.default_rng(3)
    rand = rng.normal(0, 3, (2, 64)).astype(np.float32)
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0x40490000 | 0x8000,
                     0x3F80C000, 0x3F807FFF], np.uint32).view(np.float32)
    a = np.concatenate([rand[0], ties, [0.7, -0.3, 1e-3, 0.0, 0.0, 6e4]])
    b = np.concatenate([rand[1], ties[::-1], [0.0, 0.0, 0.0, 0.0, -0.0,
                                             1e-40]])
    return a.astype(np.float32), b.astype(np.float32)


def test_pack_bf16_pair_bitwise_jax():
    a, b = _pair_inputs()
    ref = np.asarray(jbin.pack_bf16_pair(jnp.asarray(a), jnp.asarray(b)))
    got = tbin.pack_bf16_pair(torch.tensor(a), torch.tensor(b))
    assert got.dtype == torch.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  ref.view(np.uint32))
    # the denormal readings (b rounds to 0, a does not) came back whole
    assert (np.abs(ref[b == 0]) < np.finfo(np.float32).tiny).any()
    ra, rb = jbin.unpack_bf16_pair(jnp.asarray(ref))
    ga, gb = tbin.unpack_bf16_pair(got)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    np.testing.assert_array_equal(gb.numpy(), np.asarray(rb))
    np.testing.assert_array_equal(
        ga.numpy(), torch.tensor(a).to(torch.bfloat16).float().numpy())
    # the [8, D] payload's pairs unpack to the four rows, in packet order
    cols = torch.cat([torch.zeros(6, a.size), got[None], got.flip(0)[None]])
    rows = tbin.unpack_feature_pairs(cols)
    assert rows.shape == (10, a.size) and rows.is_contiguous()
    torch.testing.assert_close(rows[6:], torch.stack(
        [ga, gb, ga.flip(0), gb.flip(0)]), rtol=0, atol=0)


def _zero_green(arrays):
    out = dict(arrays)
    sh_dc = np.array(out["sh_dc"])
    sh_dc[:, :, 1] = -0.5 / C0              # rgb green 0 before the clamp
    out["sh_dc"] = sh_dc
    if "sh_rest" in out:
        rest = np.array(out["sh_rest"])
        rest[:, :, 1] = 0.0
        out["sh_rest"] = rest
    return out


@pytest.mark.parametrize("zero_green", [False, True], ids=["rgb", "g0"])
def test_bf16_sorted_payload_bitwise_jax(zero_green):
    from gs_tpu.core.gaussians import GaussianParams as JGaussianParams
    from gs_tpu.core.project import preprocess
    from utils import default_camera, random_params
    params = random_params(np.random.default_rng(7), 300)
    if zero_green:
        params = JGaussianParams(**{k: jnp.asarray(v) for k, v in _zero_green(
            {k: np.asarray(getattr(params, k)) for k in FIELDS}).items()})
    cam = default_camera(96, 64)
    proj = preprocess(params, cam, active_sh_degree=1,
                      alive=np.arange(300) < 280)
    jb, jcols = jbin.bin_gaussians_payload(
        proj, jax_pack(proj), cam.width, cam.height, 16, 16, 4096,
        expand="pallas", expand_interpret=True, bf16_pairs=True)
    tproj = _to_torch(proj)
    tb, tcols = tbin.bin_gaussians_payload(
        tproj, pack_projected(tproj), cam.width, cam.height, 16, 16, 4096,
        bf16_pairs=True)
    assert tcols.shape == (8, 4096) and len(jcols) == 8
    np.testing.assert_array_equal(tcols.numpy().view(np.uint32),
                                  np.stack(jcols).view(np.uint32))
    np.testing.assert_array_equal(tb.entry_gid.numpy(),
                                  np.asarray(jb.entry_gid))
    if zero_green:
        r, g = tbin.unpack_bf16_pair(tcols[6])
        valid = tb.entry_valid.numpy()
        assert not g.numpy()[valid].any() and r.numpy()[valid].any()


def _render_pair(zero_green, bf16, backend="pallas_interpret"):
    """(JAX output and gradients, port output and gradients) of one render
    of small_scene's 300 Gaussians at 64x48, for an L1 + invdepth loss."""
    params, cam, _, tcam = small_scene()
    arrays = {k: np.asarray(getattr(params, k)) for k in FIELDS}
    if zero_green:
        arrays = _zero_green(arrays)
    bg = np.array([0.2, 0.3, 0.4], np.float32)
    kw = dict(active_sh_degree=2, dup_capacity=1 << 14, max_per_tile=256,
              bf16_features=bf16)
    from gs_tpu.core.gaussians import GaussianParams as JGaussianParams

    def jloss(p):
        o = jax_render(cam, p, jnp.asarray(bg), backend=backend, **kw)
        return jnp.mean(jnp.abs(o.image - 0.5)) + 0.1 * jnp.mean(o.invdepth), o

    jp = JGaussianParams(**{k: jnp.asarray(v) for k, v in arrays.items()})
    (jl, jo), jg = jax.value_and_grad(jloss, has_aux=True)(jp)
    leaves = [t.requires_grad_(True) for t in params_from_numpy(arrays, "cpu")]
    to = render(tcam, GaussianParams(*leaves), torch.from_numpy(bg),
                backend="cuda" if backend == "pallas_interpret" else backend,
                **kw)
    tl = (to.image - 0.5).abs().mean() + 0.1 * to.invdepth.mean()
    tg = torch.autograd.grad(tl, leaves)
    ref = dict(loss=float(jl), **{k: np.asarray(getattr(jo, k)) for k in
                                  ("image", "invdepth", "final_T")},
               grads={k: np.asarray(getattr(jg, k)) for k in FIELDS})
    got = dict(loss=float(tl), **{k: getattr(to, k).detach().numpy() for k in
                                  ("image", "invdepth", "final_T")},
               grads={k: g.numpy() for k, g in zip(FIELDS, tg)})
    return ref, got


def _assert_close(got, ref):
    for k in ("image", "invdepth", "final_T"):
        np.testing.assert_allclose(got[k], ref[k], atol=2e-5, rtol=0,
                                   err_msg=k)
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for k, want in ref["grads"].items():
        scale = max(float(np.abs(want).max()), 1e-12)
        err = float(np.abs(got["grads"][k] - want).max())
        assert err <= 2e-4 * scale, (k, err, scale)


@pytest.mark.parametrize("zero_green", [False, True], ids=["rgb", "g0"])
def test_bf16_render_matches_jax(zero_green):
    ref, got = _render_pair(zero_green, bf16=True)
    _assert_close(got, ref)
    # the frame really streamed bf16, within JAX's envelope of the f32 one
    _, got32 = _render_pair(zero_green, bf16=False, backend="binned")
    diff = np.abs(got["image"] - got32["image"]).max()
    assert 0 < diff <= 1e-2
    assert np.abs(got["invdepth"] - got32["invdepth"]).max() <= 1e-2
    if zero_green:
        assert got["image"][0].max() > 0.3     # red survives zero green


def test_binned_ignores_bf16():
    ref16, got16 = _render_pair(False, bf16=True, backend="binned")
    ref32, got32 = _render_pair(False, bf16=False, backend="binned")
    for k in ("image", "invdepth", "final_T"):
        np.testing.assert_array_equal(ref16[k], ref32[k])
        np.testing.assert_array_equal(got16[k], got32[k])
    for k in FIELDS:
        np.testing.assert_array_equal(got16["grads"][k], got32["grads"][k])
    _assert_close(got16, ref16)


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_bf16_pairs_and_render(cuda_device):
    """The pairs packed on the card are bitwise the CPU's; the bf16 render
    through K2 and K1 holds the CPU plain path under the backends' image
    rule (max < 2e-2, under 0.2 % of values beyond 1e-5)."""
    from gs_tpu_torch.convert import camera_from_numpy
    a, b = _pair_inputs()
    got = tbin.pack_bf16_pair(torch.tensor(a, device=cuda_device),
                              torch.tensor(b, device=cuda_device))
    ref = tbin.pack_bf16_pair(torch.tensor(a), torch.tensor(b))
    assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32))
    _, cam, tparams, tcam = small_scene()
    bg = torch.tensor([0.2, 0.3, 0.4])
    kw = dict(active_sh_degree=2, dup_capacity=1 << 14, max_per_tile=256,
              bf16_features=True)
    cpu = render(tcam, tparams, bg, **kw)
    gcam = camera_from_numpy({k: np.asarray(getattr(cam, k)) for k in (
        "world_view", "full_proj", "camera_center", "tan_fovx", "tan_fovy")},
        cam.width, cam.height, cuda_device)
    card = render(gcam, GaussianParams(*[t.to(cuda_device) for t in tparams]),
                  bg.to(cuda_device), **kw)
    for k in ("image", "invdepth", "final_T"):
        diff = (getattr(card, k).cpu() - getattr(cpu, k)).abs()
        assert float(diff.max()) < 2e-2, k
        assert float((diff > 1e-5).double().mean()) < 2e-3, k
